"""The port's copies of the config layer and the energy meter agree with the
JAX package's originals on every arch and plan."""
import pytest

from repro import configs as jcfg
from repro.configs import plan as jplan
from repro.core import energy as jenergy
from repro_torch import configs as tcfg
from repro_torch.configs import plan as tplan
from repro_torch.core import energy as tenergy

PLANS = {
    "stock": (),
    "ffn": (("ffn.*", {"enabled": True}),),
    "ffn_chained": (("ffn.*", {"enabled": True}), ("ffn.in", {"chain": True})),
    "all_sites_p7": (("*", {"enabled": True, "bits": 7, "weight_bits": 7}),),
}


def _build(pkg, arch, plan, smoke):
    cfg = pkg.get_config(arch)
    if smoke:
        cfg = pkg.smoke(cfg)
    if plan:
        cfg = cfg.replace(tdvmm_plan=pkg.TDVMMPlan(rules=tuple(
            pkg.tdvmm_rule(pat, **kw) for pat, kw in plan)))
    return cfg


def _outcome(fn):
    try:
        return ("ok", fn())
    except (ValueError, NotImplementedError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("arch", sorted(jcfg.ARCHS))
def test_plan_report_and_energy_match_reference(arch, plan):
    assert sorted(tcfg.ARCHS) == sorted(jcfg.ARCHS)
    for smoke in (False, True):
        jc = _build(jcfg, arch, PLANS[plan], smoke)
        tc = _build(tcfg, arch, PLANS[plan], smoke)
        assert _outcome(lambda: tplan.resolve_plan(tc).report()) == \
            _outcome(lambda: jplan.resolve_plan(jc).report())
        assert _outcome(lambda: tplan.site_linear_shapes(tc)) == \
            _outcome(lambda: jplan.site_linear_shapes(jc))
        for tile_n in (64, 256):
            assert _outcome(lambda: tenergy.serving_energy_model(tc, tile_n)) \
                == _outcome(lambda: jenergy.serving_energy_model(jc, tile_n))


def test_energy_helpers_match_reference():
    jc = _build(jcfg, "qwen1.5-0.5b", PLANS["ffn_chained"], False)
    tc = _build(tcfg, "qwen1.5-0.5b", PLANS["ffn_chained"], False)
    je = jenergy.serving_energy_model(jc)
    te = tenergy.serving_energy_model(tc)
    assert tenergy.token_cost(te, 37) == jenergy.token_cost(je, 37)
    assert tenergy.site_attribution(te, 1234) == \
        jenergy.site_attribution(je, 1234)
    assert tenergy.cost(256, 6) == tenergy.CostBreakdown(
        **vars(jenergy.cost(256, 6)))
