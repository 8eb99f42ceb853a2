"""The bound arithmetic against hand counts at the cells' shapes
(``MDMConfig()`` widths: D 512, ff 1024, 8 layers, C 1536, A 256)."""

import json
from pathlib import Path

import pytest

from benchmark import roofline as R

MDM = json.loads((Path(__file__).resolve().parents[1] / "configs" / "beat2.json").read_text())["mdm"]


def test_k1_window_at_b1():
    # per layer 2*32*(512*1536 + 512*512 + 2*512*1024) = 134,217,728 product FLOP, 8 layers
    mm, attn = R.block_flops(MDM, 1, 32)
    assert (mm, attn) == (1_073_741_824, 16_777_216)
    # per step: the stack, in/out projections and the x slab (64*1,835,008), the style row (2*512*512)
    bf, f32 = R.window_flops(MDM, 1, 32, 50)
    assert bf == 50 * (1_073_741_824 + 117_440_512 + 524_288) + 8_388_608 == 59_593_719_808
    assert f32 == 838_860_800
    assert R.k1_bound_s(MDM, 1, 32, 50) == pytest.approx(59_593_719_808 / 989e12 + 838_860_800 / 67e12)


def test_k2_pass_at_24_samples():
    mm, attn = R.block_flops(MDM, 24, 32)
    assert (mm, attn) == (25_769_803_776, 402_653_184)
    # bytes: f32 activations in and out 2*4*768*512, bf16 weights 8*2*2,097,152, f32 norms and biases 8*4*4096
    assert R.block_weight_bytes(MDM) == 8 * (2 * 2_097_152 + 4 * 4096)
    assert R.k2_bound_s(MDM, 24, 32) == pytest.approx(25_769_803_776 / 989e12 + 402_653_184 / 67e12)


def test_k3_snap_of_a_stream_window():
    # 52 rows (16 + 28 + 8 latent frames) through 6 codebooks of 512 x 512 in f32 FMAs
    assert R.k3_bound_s(52, 6, 512, 512) == pytest.approx(2 * 52 * 6 * 512 * 512 / 67e12)
    # at 4 rows the codebooks' 6.3 MB bound it
    assert R.k3_bound_s(4, 6, 512, 512) == pytest.approx(4 * (2 * 4 * 512 + 6 * 512 * 512 + 4 * 6) / 3.35e12)


def test_encode_and_decode_flops_follow_the_strides():
    # 128 frames of 16 kHz audio: 68,224 samples through strides 5, 6, 1, 6, 1, 3 -> 128 frames
    length = 68_224
    for _, stride, pad, _ in R.WAV_PLAN:
        length = (length + 2 * pad - 15) // stride + 1
    assert length == 128
    assert R.encode_flops(MDM, 2, 68_224, 128) == pytest.approx(2 * R.encode_flops(MDM, 1, 68_224, 128))
    r = {"width": 512, "num_quantizers": 6, "nb_code": 512, "code_dim": 512, "down_t": 2, "stride_t": 2, "depth": 3}
    one = R.decode_flops(r, {"upper": 78}, 1, 32)
    snap = 2 * 32 * 6 * 512 * 512
    convs = (2 * 512 * 512 * 3 * 32 + 3 * (2 * 512 * 512 * 3 * 32 + 2 * 512 * 512 * 32) + 2 * 512 * 512 * 3 * 64
             + 3 * (2 * 512 * 512 * 3 * 64 + 2 * 512 * 512 * 64) + 2 * 512 * 512 * 3 * 128
             + 2 * 512 * 512 * 3 * 128 + 2 * 512 * 78 * 3 * 128)
    assert one == snap + convs
