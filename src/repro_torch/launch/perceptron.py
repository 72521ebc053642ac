"""The paper's time-domain circuit, simulated on the card:

    PYTHONPATH=src python -m repro_torch.launch.perceptron [--device cpu] \\
        [--n 1024] [--batch 4096] [--seed 0] [--qat]

runs two workloads through the event-driven simulator (``core/tdcore``),
whose latch crossings go through kernel B4 on the card:

* the paper's case study at its full width (section 3, Fig. 2): the
  10 x 10 x 10 two-layer perceptron — a four-quadrant VMM, the AND-gate
  ReLU, a two-quadrant VMM — on a batch of 64, against its closed form
  (``ideal_mlp``), then deployed on 6-bit programmed weights with the DIBL
  error of the operating point (``1 + err * U(-1, 1)`` per weight), with
  the pipelined timing (Fig. 2d) and the energy per inference;
* an N x N four-quadrant array (``--n``, default 1024, the large-N end of
  Fig. 5) on ``--batch`` samples, against ``ideal_four_quadrant``, with the
  paper's energy for one window.

With ``--qat`` it runs the case study end to end instead (section 3,
``examples/perceptron_case_study.py``): the 10 x 10 x 10 perceptron is
trained with TD-VMM quantization-aware training (300 full-batch SGD steps
at lr 0.5 through ``core.layers.td_matmul``, 6-bit codes: kernel B2 on
every forward on the card, the straight-through gradient in the backward)
on a 10-class task of gaussian blobs, then deployed on the simulated
circuit (6-bit programmed weights with the DIBL error, kernel B4), and the
digital twin's and the circuit's test accuracies and the drop between them
are reported.

Weights and inputs are drawn from a CPU generator seeded with ``--seed``, so
a seed gives the same numbers on the card and on the CPU.  The closed forms
are evaluated in float64.  Without a card it raises unless given
``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core import energy, nonideal, tdcore
from repro_torch.core.constants import TDVMMSpec
from repro_torch.core.currents import quantize_weights
from repro_torch.core.layers import TDVMMLayerConfig, td_matmul
from repro_torch.models import common

SPEC = TDVMMSpec(bits=6)
CASE_WIDTH, CASE_BATCH = 10, 64
# the QAT case study: 100 samples per class, 800 to train, 200 to test;
# full-batch SGD
QAT_PER_CLASS, QAT_TRAIN, QAT_STEPS, QAT_LR = 100, 800, 300, 0.5
QAT_CFG = TDVMMLayerConfig(enabled=True, bits=6, weight_bits=6)


def _uniform(gen: torch.Generator, shape, device) -> torch.Tensor:
    """U(-1, 1) float32 from the CPU generator, moved to ``device``."""
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0).to(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _max_err(y: torch.Tensor, ideal: torch.Tensor) -> float:
    return float((y.to(torch.float64) - ideal).abs().max())


def case_study(device, seed: int = 0, batch: int = CASE_BATCH) -> dict:
    """The 10 x 10 x 10 perceptron (two B4 launches per forward), clean and
    on DIBL-perturbed 6-bit weights."""
    device = torch.device(device)
    gen = torch.Generator().manual_seed(seed)
    n = CASE_WIDTH
    w1, w2 = _uniform(gen, (n, n), device), _uniform(gen, (n, n), device)
    x = _uniform(gen, (batch, n), device)
    x64 = x.to(torch.float64)

    t0 = time.perf_counter()
    y = tdcore.td_mlp_forward(x, w1, w2, SPEC)
    _sync(device)
    seconds = time.perf_counter() - t0
    err = _max_err(y, tdcore.ideal_mlp(x64, w1.double(), w2.double(),
                                       SPEC.w_max))

    # deployment: 6-bit programming resolution, then DIBL per weight
    dibl = float(nonideal.relative_error(SPEC.i_max, SPEC.v_sg,
                                         SPEC.delta_vd))
    w1q = quantize_weights(w1, SPEC.weight_bits, SPEC.w_max)
    w2q = quantize_weights(w2, SPEC.weight_bits, SPEC.w_max)
    w1d = w1q * (1.0 + dibl * _uniform(gen, (n, n), device))
    w2d = w2q * (1.0 + dibl * _uniform(gen, (n, n), device))
    y_d = tdcore.td_mlp_forward(x, w1d, w2d, SPEC)
    ideal_d = tdcore.ideal_mlp(x64, w1d.double(), w2d.double(), SPEC.w_max)
    twin = tdcore.ideal_mlp(x64, w1q.double(), w2q.double(), SPEC.w_max)
    top = torch.argmax(y_d, dim=-1)
    cost = energy.cost(n, bits=SPEC.bits)
    return {
        "width": n, "batch": batch, "y": y, "y_dibl": y_d,
        "max_err": err, "max_err_dibl": _max_err(y_d, ideal_d),
        "dibl_error": dibl,
        # argmax of the circuit on DIBL weights against the closed form on
        # the same weights, and against the digital twin (6-bit weights)
        "argmax_agree": float((top == torch.argmax(ideal_d, -1)).double()
                              .mean()),
        "argmax_agree_twin": float((top == torch.argmax(twin, -1)).double()
                                   .mean()),
        "pipeline": tdcore.pipeline_schedule(2, batch, SPEC),
        "energy_pj_per_inference": 2.0 * cost.e_total_j * 1e12,
        "seconds": seconds,
    }


def array(device, n: int = 1024, batch: int = 4096, seed: int = 0) -> dict:
    """An n x n four-quadrant VMM on ``batch`` samples: one B4 launch of
    (batch, 2n + 1) onsets against (2n + 1, 2n) currents."""
    device = torch.device(device)
    gen = torch.Generator().manual_seed(seed + 1)
    w = _uniform(gen, (n, n), device)
    x = _uniform(gen, (batch, n), device)
    _sync(device)
    t0 = time.perf_counter()
    y = tdcore.td_vmm_four_quadrant(x, w, SPEC)
    _sync(device)
    seconds = time.perf_counter() - t0
    ideal = tdcore.ideal_four_quadrant(x.to(torch.float64),
                                       w.to(torch.float64), SPEC.w_max)
    cost = energy.cost(n, bits=SPEC.bits)
    return {"n": n, "batch": batch, "y": y, "max_err": _max_err(y, ideal),
            "seconds": seconds, "fj_per_op": cost.e_per_op_j * 1e15,
            "energy_pj_per_window": cost.e_total_j * 1e12,
            "tops_per_j": cost.tops_per_j}


def blobs(gen: torch.Generator, n_cls: int = CASE_WIDTH,
          per_class: int = QAT_PER_CLASS):
    """The example's task: 10-dim gaussian blobs (centers U(-0.8, 0.8),
    spread 0.25), shuffled and clipped to [-1, 1]; (x, labels)."""
    centers = torch.rand((n_cls, CASE_WIDTH), generator=gen) * 1.6 - 0.8
    xs = torch.cat([centers[i] + 0.25 * torch.randn(
        (per_class, CASE_WIDTH), generator=gen) for i in range(n_cls)])
    ys = torch.arange(n_cls).repeat_interleave(per_class)
    perm = torch.randperm(xs.shape[0], generator=gen)
    return torch.clamp(xs[perm], -1.0, 1.0), ys[perm]


def forward_qat(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The digital twin: two TD-VMM layers (B2 each on the card) with a
    ReLU between."""
    return td_matmul(torch.relu(td_matmul(x, p["w1"], QAT_CFG)), p["w2"],
                     QAT_CFG)


def qat_case_study(device, seed: int = 0, steps: int = QAT_STEPS) -> dict:
    """Train the 10 x 10 x 10 perceptron with TD-VMM QAT, then deploy it on
    the simulated circuit with DIBL (two B4 launches)."""
    device = torch.device(device)
    gen = torch.Generator().manual_seed(seed)
    x, y = blobs(gen)
    x, y = x.to(device), y.to(device)
    x_tr, y_tr, x_te, y_te = (x[:QAT_TRAIN], y[:QAT_TRAIN], x[QAT_TRAIN:],
                              y[QAT_TRAIN:])
    n = CASE_WIDTH
    params = {k: (0.5 * torch.randn((n, n), generator=gen)).to(device)
              for k in ("w1", "w2")}
    rows = torch.arange(QAT_TRAIN, device=device)
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        for v in params.values():
            v.requires_grad_(True)
        logp = torch.log_softmax(forward_qat(params, x_tr), dim=-1)
        loss = -torch.mean(logp[rows, y_tr])
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            params = {k: v - QAT_LR * g
                      for (k, v), g in zip(params.items(), grads)}
        losses.append(loss.detach())
    with torch.no_grad():
        acc_digital = float((torch.argmax(forward_qat(params, x_te), -1)
                             == y_te).double().mean())
    _sync(device)
    train_s = time.perf_counter() - t0

    # deploy on the circuit: 6-bit programming, then DIBL per weight
    dibl = float(nonideal.relative_error(SPEC.i_max, SPEC.v_sg,
                                         SPEC.delta_vd))
    w1n = quantize_weights(params["w1"] / params["w1"].abs().max(), 6, 1.0)
    w2n = quantize_weights(params["w2"] / params["w2"].abs().max(), 6, 1.0)
    w1d = w1n * (1.0 + dibl * _uniform(gen, (n, n), device))
    w2d = w2n * (1.0 + dibl * _uniform(gen, (n, n), device))
    logits_td = tdcore.td_mlp_forward(x_te, w1d, w2d, SPEC)
    acc_td = float((torch.argmax(logits_td, -1) == y_te).double().mean())
    ideal = tdcore.ideal_mlp(x_te.double(), w1d.double(), w2d.double(), 1.0)
    return {"steps": steps, "loss_first": float(losses[0]),
            "loss_last": float(losses[-1]), "acc_digital": acc_digital,
            "acc_circuit": acc_td, "drop": acc_digital - acc_td,
            "dibl_error": dibl, "max_err": _max_err(logits_td, ideal),
            "train_s": train_s, "logits": logits_td}


def _summary(out: dict) -> dict:
    return {k: v for k, v in out.items() if not isinstance(v, torch.Tensor)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain torch path; default: the card")
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--qat", action="store_true",
                    help="train the perceptron with TD-VMM QAT, then deploy "
                         "it on the circuit")
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    if args.qat:
        out = qat_case_study(device, args.seed)
        print(f"QAT digital-twin test accuracy: {out['acc_digital']:.3f}")
        print(f"time-domain circuit (event-driven + DIBL "
              f"{out['dibl_error'] * 100:.1f}%) accuracy: "
              f"{out['acc_circuit']:.3f}")
        print(f"crossing-sim vs closed-form max err: {out['max_err']:.2e}")
        print(f"accuracy drop from analog deployment: {out['drop']:+.3f}")
        if out["acc_circuit"] <= 0.8:
            raise RuntimeError("time-domain deployment should preserve "
                               "accuracy (> 0.8)")
        return {"qat": out}
    case = case_study(device, args.seed)
    print("[perceptron] case study 10x10x10, batch 64: "
          + json.dumps(_summary(case)))
    arr = array(device, args.n, args.batch, args.seed)
    print(f"[perceptron] array {args.n}x{args.n}, batch {args.batch}: "
          + json.dumps(_summary(arr)))
    return {"case_study": case, "array": arr}


if __name__ == "__main__":
    main()
