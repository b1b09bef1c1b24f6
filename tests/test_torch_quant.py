"""K11 (the W8A8 int8 linear) against the JAX package's ``int8_linear``.

On the CPU the port's wrapper runs its plain twin; the Pallas kernel runs in
interpret mode (tests/conftest.py).  The shapes are tests/test_quant.py's:
rows 100 and 512 (ragged against JAX's 256-row padding), k 256, n 384 and
640, 3-D activations.  The weight and activation quantisations are plain
tensor ops on both sides and must agree exactly; the int32 sums are exact
on both, so the outputs differ only by the epilogue's rounding: XLA:CPU
contracts the interpreted ``acc * sx * sw + b`` into an FMA where the port
rounds each step, which is within 1e-6 of the output's scale in fp32, and
after the cast to bf16 within one bf16 ulp of each output beyond that.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vda_tpu.ops import quant as jquant

import vda_tpu_torch.ops as tops
from vda_tpu_torch.ops import quant
from vda_tpu_torch.utils.convert import load_int8_params_numpy

from tests.torch_port import rel_err

KERNELS = [f"K{i}" for i in range(1, 15)]


@pytest.fixture(autouse=True)
def counters_at_rest():
    tops.reset_launch_counts()
    yield
    assert tops.launch_counts() == dict.fromkeys(KERNELS, 0)


def _bf16_ulp(a):
    """The gap above |a| between bf16 values (fp32's gap x 2^16)."""
    return np.spacing(np.abs(a).astype(np.float32)) * 2.0 ** 16


def _case(rng, rows, k, n, bias):
    x = rng.standard_normal((3, rows, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    return x, w, b


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,k,n", [(100, 256, 384), (512, 256, 384),
                                      (100, 256, 640), (512, 256, 640)])
def test_int8_linear_matches_jax(monkeypatch, rows, k, n, dtype, bias):
    rng = np.random.default_rng(rows + n)
    x, w, b = _case(rng, rows, k, n, bias)
    jw_q, jw_s = jquant.quantize_weight(jnp.asarray(w))
    jp = {"w_q": jw_q, "w_s": jw_s, **({"b": jnp.asarray(b)} if bias else {})}
    seen = {}
    real = jquant._int8_matmul

    def spy(xq, wq, sx, sw, b32, out_dtype):
        seen.update(xq=np.asarray(xq), sx=np.asarray(sx))
        return real(xq, wq, sx, sw, b32, out_dtype)

    monkeypatch.setattr(jquant, "_int8_matmul", spy)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    ref = np.asarray(jquant.int8_linear(jp, jx))

    # the weight quantisation, exactly
    w_q, w_s = quant.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(jw_q))
    np.testing.assert_array_equal(w_s.numpy(), np.asarray(jw_s))
    # the activation quantisation, exactly (JAX pads rows to 256)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    xq, sx = quant.quantize_rows(tx.reshape(-1, k))
    m = 3 * rows
    np.testing.assert_array_equal(xq.numpy(), seen["xq"][:m])
    np.testing.assert_array_equal(sx.numpy(), seen["sx"][:m])

    p = load_int8_params_numpy(jp, device="cpu")
    assert p["w_q"].dtype == torch.int8 and p["w_s"].dtype == torch.float32
    got = quant.int8_linear(p, tx)
    assert got.shape == ref.shape == (3, rows, n)
    assert got.dtype == tx.dtype
    if dtype == "float32":
        assert rel_err(ref, got.numpy()) < 1e-6
    else:
        # one bf16 ulp of each output, after the fp32 difference above
        ref, got32 = ref.astype(np.float32), got.float().numpy()
        allowed = _bf16_ulp(ref) + 1e-6 * np.abs(ref).max()
        assert (np.abs(got32 - ref) <= allowed).all()
    # and W8A8 stays within tests/test_quant.py's bound of the float linear
    dense = x @ w + (b if bias else 0)
    assert rel_err(dense, got.float().numpy()) < 2e-2


def test_int8_matmul_reference_is_the_int32_sum():
    """The twin's float64 product equals the int32 sum at the extremes
    (every product 127 * 127 or -127 * 127, K = 1024)."""
    k = 1024
    xq = torch.full((4, k), 127, dtype=torch.int8)
    xq[1] = -127
    wq = torch.full((k, 128), 127, dtype=torch.int8)
    acc = xq.to(torch.int32) @ wq.to(torch.int32)
    one = torch.ones(128)
    got = quant.int8_matmul_reference(xq, wq, torch.ones(4, 1), one,
                                      torch.zeros(128), torch.float32)
    assert torch.equal(got, acc.float())
    assert int(acc.abs().max()) == 127 * 127 * k


@pytest.mark.parametrize("n", [200, 100])
def test_unaligned_width_refused_as_in_jax(n):
    rng = np.random.default_rng(5)
    x, w, _ = _case(rng, 16, 128, n, False)
    jw_q, jw_s = jquant.quantize_weight(jnp.asarray(w))
    with pytest.raises(ValueError):
        jquant.int8_linear({"w_q": jw_q, "w_s": jw_s}, jnp.asarray(x))
    p = load_int8_params_numpy({"w_q": jw_q, "w_s": jw_s}, device="cpu")
    with pytest.raises(ValueError):
        quant.int8_linear(p, torch.from_numpy(x))


def test_transposed_weight_is_cached_until_it_changes():
    w = torch.randint(-127, 127, (40, 128), dtype=torch.int8)
    wt = quant.transposed(w)
    assert wt.shape == (128, 48)  # K padded to 16 bytes with zeros
    assert torch.equal(wt[:, :40], w.t()) and not wt[:, 40:].any()
    assert quant.transposed(w) is wt
    w[0, 0] = 5
    wt2 = quant.transposed(w)
    assert wt2 is not wt and int(wt2[0, 0]) == 5
