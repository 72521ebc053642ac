"""``perfbench.work``'s FLOPs and bytes for a small configuration, against
counts made by hand."""
import pytest

from perfbench import work

PEAKS = {"int8": 2e12, "bfloat16": 1e12, "hbm_bytes_s": 1e12}


def shape(**kw):
    base = dict(d_model=8, n_layers=1, n_heads=2, n_kv_heads=1, head_dim=4,
                vocab_size=10, n_experts=4, top_k=2, expert_d_ff=6,
                n_shared_experts=0, tdvmm="moe.*", dtype="bfloat16")
    base.update(kw)
    return work.Shape(**base)


def test_causal_contexts():
    assert work.causal_contexts(0, 3) == 1 + 2 + 3
    assert work.causal_contexts(5, 2) == 6 + 7


def test_experts_hit():
    assert work.experts_hit(0, 2, 4) == 0
    assert work.experts_hit(1, 2, 4) == pytest.approx(2.0)
    assert work.experts_hit(1000, 2, 4) == pytest.approx(4.0)


def test_step_by_hand():
    sh = shape()
    t = work.step(sh, tokens=3, contexts=6, head_rows=1, peaks=PEAKS)
    # attention: qkv 2*3*8*(2+2)*4 = 768, out 2*3*8*8 = 384, scores and
    # values 4*2*4*6 = 192, router 2*3*8*4 = 192, head 2*1*8*10 = 160
    assert t.other_flops == 768 + 384 + 192 + 192 + 160
    # experts: 6 routed rows; gate and up 2*6*8*6 each, down 2*6*6*8
    assert t.td_ops == 3 * 576
    hit = work.experts_hit(3, 2, 4)
    b_in = 6 * 8 + hit * 8 * 6 + 6 * 6 * 4 + 6 * 4 + hit * 6 * 4
    b_out = 6 * 6 + hit * 6 * 8 + 6 * 8 * 4 + 6 * 4 + hit * 8 * 4
    assert t.td_least_s == pytest.approx(
        2 * max(576 / 2e12, b_in / 1e12) + max(576 / 2e12, b_out / 1e12))
    assert t.least_s(PEAKS, "bfloat16") == pytest.approx(
        3 * 576 / 2e12 + 1696 / 1e12)


def test_shared_experts_and_layers():
    one = work.step(shape(), 5, 15, 5, PEAKS)
    two = work.step(shape(n_layers=2, n_shared_experts=1), 5, 15, 5, PEAKS)
    head = 2 * 5 * 8 * 10
    assert two.other_flops == 2 * (one.other_flops - head) + head
    # a shared expert runs every token: 3 launches of 2*5*8*6
    assert two.td_ops == 2 * (one.td_ops + 3 * 480)
