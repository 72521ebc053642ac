"""Site-addressable TD-VMM plan resolution.

Every analog matmul in a model has a **canonical site name**; a
``TDVMMPlan`` is an ordered list of (glob pattern -> field overrides) rules
resolved once per model into a concrete site table.  The paper's system
claim — tiles "chained together to implement large-scale circuits completely
in a time domain" — becomes a declared plan property: a site with
``chain=True`` pairs with its adjacent downstream tile and drops the
intermediate digital (p-bit readout) boundary.

Canonical sites by model family:

    dense / vlm / audio   attn.qkv  attn.out  ffn.in  ffn.out  head
    moe                   attn.qkv  attn.out  [ffn.* if first_k_dense]
                          moe.expert.in  moe.expert.out
                          [moe.shared.in  moe.shared.out]  head
    ssm                   ssm.in_proj  ssm.out  head
    hybrid (zamba2)       ssm.in_proj  ssm.out  [attn.* ffn.* hybrid.fuse
                          for the shared block]  head

(``head`` is absent for tied-embedding models — the tied head is a transpose
of the embedding table and never routes through ``td_matmul``.)

Resolution: each site starts from ``plan.default`` (or ``ModelConfig.tdvmm``
when the plan has no default — the deprecation shim), then every matching
rule's overrides apply in order (later rules win).  ``chain=True`` sites are
validated here: only adjacent tile pairs (``CHAINABLE``) can chain, both
ends must be enabled, and the upstream site is rewritten to
``io_quantize=False`` — its latch output feeds the next tile as turn-on
times instead of round-tripping through the shared-counter ADC.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import functools
from typing import Optional

from repro_torch.configs.base import (
    ModelConfig, TDVMMLayerConfig, TDVMMPlan, TDVMMRule)

# Adjacent tile pairs whose intermediate boundary may go analog (the
# downstream matmul consumes the upstream matmul's output directly, with only
# element-wise ops in between — attention and the SSD scan are not
# element-wise, so attn.qkv -> attn.out / ssm.in_proj -> ssm.out cannot
# chain).
CHAINABLE: dict[str, str] = {
    "ffn.in": "ffn.out",
    "moe.expert.in": "moe.expert.out",
    "moe.shared.in": "moe.shared.out",
}

# Grouped sites: one site name covering G same-input projection matrices
# that execute as a single shared-input TD-VMM launch
# (``core.layers.td_grouped_matmul``) — the input is encoded once and feeds
# all G tiles, and calibration records one (G,) window vector for the site
# (member order below).  Width 1 (everything else) is a plain 2-D launch.
GROUPED_SITES: dict[str, tuple[str, ...]] = {
    "attn.qkv": ("wq", "wk", "wv"),
    "ssm.in_proj": ("wz", "wx", "wB", "wC", "wdt"),
}


def site_group_width(site: str) -> int:
    """How many projection matrices one launch of this site covers."""
    return len(GROUPED_SITES.get(site, ())) or 1


def model_sites(cfg: ModelConfig) -> tuple[str, ...]:
    """Canonical site names present in this model, in stack order."""
    sites: list[str] = []
    attn = ("attn.qkv", "attn.out")
    ffn = ("ffn.in", "ffn.out")
    if cfg.family in ("dense", "vlm", "audio"):
        sites += [*attn, *ffn]
    elif cfg.family == "moe":
        sites += list(attn)
        if cfg.moe is not None and cfg.moe.first_k_dense:
            sites += list(ffn)
        sites += ["moe.expert.in", "moe.expert.out"]
        if cfg.moe is not None and cfg.moe.n_shared_experts:
            sites += ["moe.shared.in", "moe.shared.out"]
    elif cfg.family == "ssm":
        sites += ["ssm.in_proj", "ssm.out"]
    elif cfg.family == "hybrid":
        sites += ["ssm.in_proj", "ssm.out"]
        if cfg.hybrid_attn_every:
            sites += [*attn, *ffn]
            if cfg.hybrid_concat_embed:
                sites += ["hybrid.fuse"]
    else:
        raise ValueError(f"unknown model family {cfg.family!r}")
    if not cfg.tie_embeddings:
        sites += ["head"]
    return tuple(sites)


def site_linear_shapes(cfg: ModelConfig) -> dict[str, dict]:
    """Per-site weight-matrix shapes applied **per token**, with layer
    multiplicity — the geometry ``core.energy.serving_energy_model`` maps
    onto TD-VMM tiles for the engine's per-request energy accounting.

    Returns ``site -> {"matrices": ((d_in, d_out), ...), "per_token": n}``
    where ``matrices`` lists the weight matrices one application of the site
    touches for one token (MoE experts: only the activated top-k + shared)
    and ``per_token`` is how many layer instances apply per token.
    """
    d, hd = cfg.d_model, cfg.resolved_head_dim
    n_in = 2 if cfg.act == "silu_glu" else 1
    shapes: dict[str, dict] = {}

    def attn_ffn(layers: int, d_ff: int):
        return {
            "attn.qkv": {"matrices": ((d, cfg.n_heads * hd),
                                      (d, cfg.n_kv_heads * hd),
                                      (d, cfg.n_kv_heads * hd)),
                         "per_token": layers},
            "attn.out": {"matrices": ((cfg.n_heads * hd, d),),
                         "per_token": layers},
            "ffn.in": {"matrices": ((d, d_ff),) * n_in, "per_token": layers},
            "ffn.out": {"matrices": ((d_ff, d),), "per_token": layers},
        }

    if cfg.family in ("dense", "vlm", "audio"):
        shapes.update(attn_ffn(cfg.n_layers, cfg.d_ff))
    elif cfg.family == "moe":
        m = cfg.moe
        base = attn_ffn(cfg.n_layers, cfg.d_ff)
        if not m.first_k_dense:
            base.pop("ffn.in"), base.pop("ffn.out")
        else:
            base["ffn.in"]["per_token"] = m.first_k_dense
            base["ffn.out"]["per_token"] = m.first_k_dense
        shapes.update(base)
        moe_layers = cfg.n_layers - m.first_k_dense
        shapes["moe.expert.in"] = {
            "matrices": ((d, m.d_ff),) * (n_in * m.top_k),
            "per_token": moe_layers}
        shapes["moe.expert.out"] = {
            "matrices": ((m.d_ff, d),) * m.top_k, "per_token": moe_layers}
        if m.n_shared_experts:
            shapes["moe.shared.in"] = {
                "matrices": ((d, m.d_ff),) * (n_in * m.n_shared_experts),
                "per_token": moe_layers}
            shapes["moe.shared.out"] = {
                "matrices": ((m.d_ff, d),) * m.n_shared_experts,
                "per_token": moe_layers}
    elif cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        d_inner = s.expand * d
        n_ssm_heads = d_inner // s.head_dim
        gs = s.n_groups * s.d_state
        shapes["ssm.in_proj"] = {
            "matrices": ((d, d_inner), (d, d_inner), (d, gs), (d, gs),
                         (d, n_ssm_heads)),
            "per_token": cfg.n_layers}
        shapes["ssm.out"] = {"matrices": ((d_inner, d),),
                             "per_token": cfg.n_layers}
        if cfg.family == "hybrid" and cfg.hybrid_attn_every:
            groups = cfg.n_layers // cfg.hybrid_attn_every
            shapes.update(attn_ffn(groups, cfg.d_ff))
            if cfg.hybrid_concat_embed:
                shapes["hybrid.fuse"] = {"matrices": ((2 * d, d),),
                                         "per_token": groups}
    if not cfg.tie_embeddings:
        shapes["head"] = {"matrices": ((d, cfg.padded_vocab),), "per_token": 1}
    return shapes


def plan_launch_shapes(
    cfg: ModelConfig, m: int
) -> tuple[tuple[int, int, int, str], ...]:
    """The deduplicated (M, K, N, code_dtype) kernel launch shapes this
    model's resolved plan emits for an M-token step — the autotune work list
    ``scripts/autotune_tdvmm.py`` sweeps.

    Grouped sites emit their ragged concat launch (one (K, sum of
    lane-rounded member widths) shape, exactly what
    ``core.layers.td_grouped_matmul`` dispatches); everything else emits its
    distinct (d_in, d_out) weight shapes.  ``code_dtype`` is the noise-free
    serving storage the plan would pick (noisy codes force f32 at runtime
    but are a training-only path, not a tuning target).  Sites are included
    whether or not the resolved plan currently enables them — the work list
    is the geometry TD-VMM *would* run on this model, so tuning is not
    invalidated by flipping a site on.
    """
    from repro_torch.core.layers import _plan_code_dtype
    from repro_torch.kernels.tdvmm import tdvmm

    plan = resolve_plan(cfg)
    out: dict[tuple[int, int, int, str], None] = {}
    for site, info in site_linear_shapes(cfg).items():
        sc = plan.get(site)
        if sc is None:
            continue
        mats = info["matrices"]
        if site in GROUPED_SITES:
            k = mats[0][0]
            n_total = sum(
                tdvmm.padded_size(n_g, tdvmm.LANE, tdvmm.LANE)
                for _, n_g in mats)
            shapes = [(k, n_total)]
        else:
            shapes = sorted(set(mats))
        for k, n in shapes:
            out[(m, k, n, _plan_code_dtype(sc, k, noisy=False))] = None
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ResolvedPlan:
    """Concrete site table: every site in the model mapped to its config.

    ``chains`` lists the validated analog boundaries as (upstream,
    downstream) site pairs — the tile borders that skip the intermediate
    p-bit readout entirely.
    """
    sites: tuple[tuple[str, TDVMMLayerConfig], ...]
    chains: tuple[tuple[str, str], ...]
    unmatched: tuple[str, ...] = ()   # rule patterns matching no model site

    @functools.cached_property
    def table(self) -> dict[str, TDVMMLayerConfig]:
        return dict(self.sites)

    def __getitem__(self, site: str) -> TDVMMLayerConfig:
        return self.table[site]

    def get(self, site: str) -> Optional[TDVMMLayerConfig]:
        return self.table.get(site)

    def report(self) -> dict:
        """Plan-level precision report: per-site word widths and which tile
        boundaries stay analog (time-chained) vs digital (p-bit readout)."""
        chained_up = {up for up, _ in self.chains}
        per_site = {}
        for site, c in self.sites:
            if not c.enabled:
                boundary = "digital (td-vmm off)"
            elif site in chained_up:
                boundary = "analog (time-chained)"
            elif not c.io_quantize:
                boundary = "analog (no readout)"
            else:
                boundary = f"digital ({c.bits}-bit readout)"
            per_site[site] = {
                "enabled": c.enabled,
                "bits": c.bits,
                "weight_bits": c.weight_bits,
                "backend": c.backend,
                "boundary": boundary,
                "out_scale": c.out_scale,
                "group": site_group_width(site),
            }
        return {"sites": per_site,
                "analog_boundaries": list(self.chains),
                # Only enabled sites actually run as one grouped launch —
                # with TD-VMM off the members execute as G plain dots.
                "grouped_sites": {
                    s: list(GROUPED_SITES[s]) for s, c in self.sites
                    if s in GROUPED_SITES and c.enabled},
                "n_digital_boundaries": sum(
                    1 for _, c in self.sites if c.enabled and c.io_quantize),
                "unmatched_rules": list(self.unmatched),
                }

    def describe(self) -> str:
        rep = self.report()
        lines = ["site                 bits  group  backend  boundary"]
        for site, r in rep["sites"].items():
            grp = f"x{r['group']}" if r["group"] > 1 else "-"
            lines.append(f"{site:<20} {r['bits']:>4}  {grp:>5}  "
                         f"{r['backend']:<7}  {r['boundary']}")
        if rep["grouped_sites"]:
            grouped = ", ".join(
                f"{s} ({'+'.join(members)}: one launch)"
                for s, members in rep["grouped_sites"].items())
            lines.append(f"grouped launches: {grouped}")
        if rep["analog_boundaries"]:
            pairs = ", ".join(f"{a}->{b}" for a, b in rep["analog_boundaries"])
            lines.append(f"time-domain chains: {pairs}")
        if rep["unmatched_rules"]:
            lines.append("rules matching no site: "
                         + ", ".join(rep["unmatched_rules"]))
        return "\n".join(lines)


def _apply_rules(plan: TDVMMPlan, default: TDVMMLayerConfig,
                 site: str) -> TDVMMLayerConfig:
    cfg = plan.default if plan.default is not None else default
    for rule in plan.rules:
        if fnmatch.fnmatchcase(site, rule.pattern):
            cfg = cfg.replace(**dict(rule.overrides))
    return cfg.replace(site=site)


@functools.lru_cache(maxsize=256)
def _resolve(plan: Optional[TDVMMPlan], default: TDVMMLayerConfig,
             sites: tuple[str, ...]) -> ResolvedPlan:
    plan = plan if plan is not None else TDVMMPlan()
    for rule in plan.rules:
        if not isinstance(rule, TDVMMRule):
            raise TypeError(f"plan rules must be TDVMMRule, got {rule!r}")
    table = {s: _apply_rules(plan, default, s) for s in sites}
    # Rules that matched nothing: fine for generic cross-family plans
    # (``ffn.*`` on an SSM model), fatal under strict (catches typos that
    # would otherwise silently serve a default-configured site).
    unmatched = tuple(
        r.pattern for r in plan.rules
        if not any(fnmatch.fnmatchcase(s, r.pattern) for s in sites))
    if plan.strict and unmatched:
        raise ValueError(
            f"strict plan: rule pattern(s) {list(unmatched)} match no site "
            f"of this model (sites: {sorted(sites)})")
    # Chain validation: declared time-domain chains must pair adjacent,
    # enabled tiles; the upstream boundary then goes analog.
    chains: list[tuple[str, str]] = []
    for site, cfg in table.items():
        if not cfg.chain:
            continue
        down = CHAINABLE.get(site)
        if down is None:
            raise ValueError(
                f"site {site!r} declares chain=True but has no adjacent "
                f"downstream tile (chainable: {sorted(CHAINABLE)})")
        if down not in table:
            raise ValueError(
                f"site {site!r} chains into {down!r}, which this model does "
                f"not have (sites: {sorted(table)})")
        if not cfg.enabled or not table[down].enabled:
            raise ValueError(
                f"time-domain chain {site!r}->{down!r} needs TD-VMM enabled "
                f"on both sites (got {cfg.enabled} -> {table[down].enabled})")
        table[site] = cfg.replace(io_quantize=False)
        chains.append((site, down))
    return ResolvedPlan(sites=tuple((s, table[s]) for s in sites),
                        chains=tuple(chains), unmatched=unmatched)


def resolve_plan(cfg: ModelConfig) -> ResolvedPlan:
    """Resolve a model's plan into its concrete site table (cached — configs
    are frozen/hashable, so identical configs share one resolution)."""
    return _resolve(cfg.tdvmm_plan, cfg.tdvmm, model_sites(cfg))


def site_config(cfg: ModelConfig, site: str) -> TDVMMLayerConfig:
    """Per-site config lookup (the backing impl of ModelConfig.site_tdvmm).

    Unknown site names (not in ``model_sites``) still resolve against the
    rule list — without chain validation — so auxiliary matmuls can opt into
    plan-addressed settings without being first-class sites."""
    hit = resolve_plan(cfg).get(site)
    if hit is not None:
        return hit
    plan = cfg.tdvmm_plan if cfg.tdvmm_plan is not None else TDVMMPlan()
    return _apply_rules(plan, cfg.tdvmm, site)
