"""``chip_smoke.flash_flops``: the work that flash attention's bound in the
kernel JSON line counts, checked on the CPU. float32 rows take their
products at the 3xTF32 rate (a third of TF32's 495 TFLOP/s, as the float32
kernel runs them on the tensor cores) and the online softmax's
elementwise terms at the float32 rate; bf16 rows take their products at
the bf16 tensor-core rate, as before."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

# every flash row of the JSON line: the paths' shapes, head dim 8 in both
# dtypes, the training rows (bf16)
ROWS = [(label, name, shape) for label, name, shape in cs.FLASH_PATH_SHAPES]
ROWS += [(f"hd8_{tag}", name, dict(cs.FLASH_TRAIN_SHAPES)["hd8"][:7])
         for tag, name in (("f32", "float32"), ("bf16", "bfloat16"))]
ROWS += [(label, "bfloat16", shape[:7]) for label, shape in
         cs.FLASH_TRAIN_SHAPES if label.startswith("train_")]


def _pairs(sq, sk, causal):
    return sum(min(i + sk - sq, sk - 1) + 1 for i in range(sq)) if causal \
        else sq * sk


def test_detect_head_products_at_the_3xtf32_rate():
    b, sq, sk, h, kh, hd, causal = cs.DETECT_FLASH
    products, softmax = cs.flash_flops(b, sq, sk, h, hd, causal, "float32")
    assert products == (17_179_869_184.0, 165e12)
    assert softmax == (4.0 * 8 * 2 * 4096 * 4096, 67e12)
    bound_us = sum(f / p for f, p in (products, softmax)) * 1e6
    assert bound_us == pytest.approx(104.120 + 16.026, abs=1e-3)


@pytest.mark.parametrize("label,name,shape", ROWS,
                         ids=[r[0] for r in ROWS])
def test_flash_row_terms(label, name, shape):
    """Products over the kept pairs (4 hd flops a pair and head) at the
    dtype's tensor-core rate; in float32 also 4 flops a pair of softmax at
    67 TFLOP/s, and never the products at 67 TFLOP/s."""
    b, sq, sk, h, kh, hd, causal = shape
    n = b * h * _pairs(sq, sk, causal)
    terms = cs.flash_flops(b, sq, sk, h, hd, causal, name)
    if name == "float32":
        assert terms == [(4.0 * hd * n, cs.TF32_FLOPS / 3),
                         (4.0 * n, cs.F32_FLOPS)]
        assert all(f < 4.0 * hd * n for f, p in terms if p == cs.F32_FLOPS)
    else:
        assert terms == [(4.0 * hd * n, cs.BF16_FLOPS)]


def test_float32_hd128_row_on_the_qwen2_7b_prefill():
    """The new float32 row: qwen2-7b's prefill shape (2, 512, 28/4, 128),
    causal; bound by its operations (23.26 us) over its bytes (10.02)."""
    shape = dict((label, (name, s)) for label, name, s in
                 cs.FLASH_PATH_SHAPES)["qwen2_7b_f32"]
    assert shape == ("float32", (cs.QWEN_B, cs.QWEN_PROMPT, cs.QWEN_PROMPT,
                                 28, 4, 128, True))
    b, sq, sk, h, kh, hd, causal = shape[1]
    by_ops = sum(f / p for f, p in cs.flash_flops(b, sq, sk, h, hd, causal,
                                                  "float32"))
    nbytes = (2 * b * sq * h * hd + 2 * b * sk * kh * hd) * 4
    assert by_ops * 1e6 == pytest.approx(23.260, abs=1e-3)
    assert nbytes / cs.HBM_BYTES_PER_S * 1e6 == pytest.approx(10.016,
                                                              abs=1e-3)
