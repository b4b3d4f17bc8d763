"""Every count of the yardstick against a value worked by hand at the
published widths (``portbench/configs``), and the SSD's at the program's
hybrid."""

import json

import pytest

from portbench.harness import counts
from portbench.tests.smoke import ROOT


def config(name):
    return json.loads((ROOT / "portbench" / "configs"
                       / f"{name}.json").read_text())


QWEN = config("qwen3-1.7b-lnffn")
# the program's hybrid family as it runs zamba2-2.7b (its shared block
# reads the 2560-wide stream alone; Zamba2's own reads 5120): the SSD's
# count at scale, for a later cell
ZAMBA = dict(QWEN, n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
             head_dim=0, d_ff=10240, vocab=32000, block_kind="ssm",
             ssm={"d_state": 64, "head_dim": 64, "expand": 2,
                  "conv_width": 4, "chunk": 256, "n_groups": 1},
             hybrid_attn_every=6, qk_norm=False)


def test_qwen3_forward_flops():
    # a layer's projections: wq 2048·16·128 + wk, wv 2048·8·128 + wo
    # 16·128·2048 = 12 582 912; the FFN's kept weights 2 · 16·6144 +
    # 16·2048 = 229 376; 28 layers
    assert counts.token_weights(QWEN) == 28 * (12_582_912 + 229_376)
    # S = 2048: 2 098 176 causal pairs a sequence, 4·128·16 FLOP a pair a
    # layer; the tied head 151 936 · 2048 at every position
    want = (2 * 358_744_064 * 2048 + 28 * 8192 * 2_098_176
            + 2 * 311_164_928 * 2048)
    assert counts.forward_flops(QWEN, 1, 2048, 2048) == want
    assert want / 2048 == 1_574_813_696
    assert counts.train_step_flops(QWEN, 4, 2048) == 3 * 4 * want
    # prefill: the head at the last position of each of 2 sequences
    assert counts.prefill_flops(QWEN, 2, 4096) == pytest.approx(
        2 * 358_744_064 * 8192 + 28 * 8192 * 2 * 4096 * 4097 / 2
        + 2 * 311_164_928 * 2)


def test_zamba2_forward_flops():
    # 9 sites of the shared block: projections 4 · 2560² = 26 214 400,
    # kept FFN weights 2 · 16·10240 + 16·2560 = 368 640; 54 Mamba2 layers:
    # in_proj 2560 · (2·5120 + 2·64 + 80), out_proj 5120 · 2560
    assert counts.token_weights(ZAMBA) == (9 * 26_583_040
                                           + 54 * 39_854_080)
    # SSD 6 · 64 · 64 · 80 heads a token a layer; attention 4·80·32 a
    # causal pair a site; the head 32 000 · 2560
    want = (2 * 2_391_367_680 * 2048 + 54 * 1_966_080 * 2048
            + 9 * 10_240 * 2_098_176 + 2 * 81_920_000 * 2048)
    assert counts.forward_flops(ZAMBA, 1, 2048, 2048) == want
    assert want / 2048 == 5_147_161_600


def test_masked_matmul_bounds():
    # wi at M = 8192: x 8192·2048, w and mask 2048·6144, out 8192·6144
    # bfloat16 = 184 549 376 bytes at 3.35 TB/s; its 2·M·nnz FLOP take
    # 1.6 µs, so the bytes bound it
    wi = 184_549_376 / 3.35e12
    wo = 2 * (8192 * 6144 + 2 * 6144 * 2048 + 8192 * 2048) / 3.35e12
    assert counts.product_bound_s(8192, 2048, 6144, 16 * 6144) == wi
    assert counts.masked_matmul_bound_s(QWEN, 8192, backward=False) \
        == pytest.approx(28 * (2 * wi + wo))
    # the input gradients move the same bytes as the forward's products
    assert counts.masked_matmul_bound_s(QWEN, 8192, backward=True) \
        == pytest.approx(2 * 28 * (2 * wi + wo))


def test_flash_bound():
    # (4, 16, 8, 2048, 128): 68 753 031 168 FLOP at 989 TFLOP/s beat
    # 100 663 296 bytes at 3.35 TB/s
    assert counts.flash_bound_s(QWEN, 4, 2048) == pytest.approx(
        28 * 4 * 128 * 16 * 4 * 2_098_176 / 989e12)


def test_kept_connections_bound_the_mfu():
    """A dense FFN counts 3·d·d_ff a token; the LogicNet-FFN its kept
    connections.  A step run at the peak on the dense count would read
    above 100 % only if the masked config counted the dense products:
    it does not, so the masked count is the smaller by exactly the pruned
    products, and a step as fast as its own count reads 100 %."""
    dense = dict(QWEN, logicnet_ffn=None)
    pruned = 28 * (3 * 2048 * 6144 - 229_376)
    assert (counts.train_step_flops(dense, 4, 2048)
            - counts.train_step_flops(QWEN, 4, 2048)) \
        == 3 * 2 * pruned * 8192
    from types import SimpleNamespace

    from portbench.harness.runner import Run
    from portbench.harness.spec import load_reader

    class Cell:
        kind, config = "train", QWEN

    fastest = counts.train_step_flops(QWEN, 4, 2048) / counts.PEAK_BF16_FLOPS
    read = load_reader(ROOT / "portbench" / "metrics" / "step_mfu.train.py")
    busy = SimpleNamespace(units=[{"key": 0}] * 2, busy_s=2 * fastest)
    run = Run(cell=Cell, window={"batch": 4, "seq_len": 2048, "steps": 9,
                                 "seconds": 1.0},
              trace=busy, peak_bytes=0)
    assert read(run) == pytest.approx(100.0)
    busy.busy_s = 2 * counts.train_step_flops(dense, 4, 2048) \
        / counts.PEAK_BF16_FLOPS
    assert read(run) < 100.0
