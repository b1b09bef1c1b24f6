"""The host-side repairs that keep a forward and a steady streaming step from
making the host wait for the device, checked on the CPU.

The resize matrices and the ImageNet constants come from device caches
(``ops.resize.device_matrix``, ``utils.transform.imagenet_stats``): the same
tensor for the same key, and outputs bit-identical with the computation
that built and uploaded them at every call.  ``StreamingDepth`` stages its
uploads in pinned buffers only on a CUDA device; on the CPU it makes none
and still equals the JAX package's stream within tests/test_torch_stream.py's
bound (1e-4 of the output scale, fp32: summation order only).  Whether the
card's steps really return before the device finishes is checked on the card
(tests/test_torch_cuda.py and chip_smoke.py's ``host_sync`` phase).
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU, as the other parity tests)

from vda_tpu.infer import streaming as jstream

import vda_tpu_torch as vt
from vda_tpu_torch.ops import resize
from vda_tpu_torch.utils import transform

from tests.torch_port import rel_err, small_models

CPU = torch.device("cpu")
TOL = 1e-4  # tests/test_torch_stream.py's bound


def _uncached_separable(x, mh, mw):
    """The separable resize as it ran before the cache: both matrices built
    and moved to the input's device at every call."""
    dtype = x.dtype if x.dtype == torch.bfloat16 else torch.float32
    a_h = torch.from_numpy(mh).to(x.device, dtype)
    a_w = torch.from_numpy(mw).to(x.device, dtype)
    y = torch.einsum("oh,...hwc->...owc", a_h, x.to(dtype))
    y = torch.einsum("pw,...owc->...opc", a_w, y)
    return y.to(x.dtype)


def test_device_matrix_is_cached_by_key():
    a = resize.device_matrix("cubic", 70, 56, False, None, CPU, torch.float32)
    assert resize.device_matrix("cubic", 70, 56, False, None, CPU,
                                torch.float32) is a
    others = [
        resize.device_matrix("cubic", 70, 56, False, None, CPU,
                             torch.bfloat16),
        resize.device_matrix("cubic", 70, 42, False, None, CPU,
                             torch.float32),
        resize.device_matrix("cubic", 70, 56, False, 0.8, CPU,
                             torch.float32),
        resize.device_matrix("linear", 70, 56, False, None, CPU,
                             torch.float32)]
    assert all(o is not a for o in others)
    assert torch.equal(a, torch.from_numpy(resize._cubic_matrix(70, 56,
                                                                False)))
    assert others[0].dtype == torch.bfloat16 and others[1].shape == (42, 70)
    mean, std = transform.imagenet_stats(CPU)
    assert transform.imagenet_stats(CPU)[0] is mean
    assert mean.tolist() == pytest.approx(transform.IMAGENET_MEAN)
    assert std.tolist() == pytest.approx(transform.IMAGENET_STD)


# (kind, input shape, output size, align_corners, scale): preprocessing of a
# small frame and of a 480x640 frame to 518 (37 patches of 14) x 686, the
# pos-embed bicubic of a 37x37 grid to 37x49 with an explicit scale, and a
# head upsample (bilinear, align_corners)
CASES = [
    ("cubic", (2, 70, 90, 3), (56, 70), False, None),
    ("cubic", (1, 480, 640, 3), (518, 686), False, None),
    ("cubic", (1, 37, 37, 64), (37, 49), False, (37.1 / 37, 49.1 / 37)),
    ("linear", (2, 37, 49, 32), (74, 98), True, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,shape,out_hw,align,scale", CASES)
def test_separable_resize_bit_identical(kind, shape, out_hw, align, scale,
                                        dtype):
    x = torch.from_numpy(np.random.default_rng(len(shape) + shape[1])
                         .standard_normal(shape).astype(np.float32)).to(dtype)
    build = resize._cubic_matrix if kind == "cubic" else resize._linear_matrix
    sh, sw = scale if scale is not None else (None, None)
    mh = build(shape[1], out_hw[0], align, sh)
    mw = build(shape[2], out_hw[1], align, sw)
    if kind == "cubic":
        got = resize.resize_bicubic(x, out_hw, align, scale)
    else:
        got = resize.resize_bilinear(x, out_hw, align)
    assert got.dtype == dtype and got.shape[1:3] == out_hw
    assert torch.equal(got, _uncached_separable(x, mh, mw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,out_hw", [((70, 90), (56, 70)),
                                       ((480, 640), (518, 686))])
def test_preprocess_frames_bit_identical(hw, out_hw, dtype):
    u8 = torch.from_numpy((np.random.default_rng(hw[0]).random(
        (2, *hw, 3)) * 255).astype(np.uint8))
    got = transform.preprocess_frames(u8, out_hw, dtype=dtype)
    x = u8.float() / 255.0
    x = _uncached_separable(x, resize._cubic_matrix(hw[0], out_hw[0], False),
                            resize._cubic_matrix(hw[1], out_hw[1], False))
    mean = torch.tensor(transform.IMAGENET_MEAN)
    std = torch.tensor(transform.IMAGENET_STD)
    assert torch.equal(got, ((x - mean) / std).to(dtype))


def test_cpu_stream_matches_jax_without_pinned_buffers():
    """Six steps of the small config (its motion modules at C=640 and 128)
    on the CPU against the JAX package's stream; no pinned buffer is made
    (``pin_memory`` raises on a PyTorch built without CUDA)."""
    params, jcfg, model, _ = small_models(seed=3)
    model.requires_grad_(False)
    frames = (np.random.default_rng(3).random((6, 70, 90, 3))
              * 255).astype(np.uint8)
    ref = jstream.StreamingDepth(params, jcfg, input_size=56, fp32=True)
    got = vt.StreamingDepth(model, input_size=56, fp32=True)
    for i, f in enumerate(frames):
        d_ref, d = np.asarray(ref(f)), got(f)
        assert d.shape == (70, 90) and rel_err(d_ref, d) < TOL, i
        assert got.order == ref.order, i
    assert float(np.abs(d_ref).max()) > 1e-2
    assert got._upload_frame.slots == [None, None]
    assert got._upload_rows.slots == [None, None]


def test_upload_on_the_cpu_moves_the_tensor_as_it_is():
    from vda_tpu_torch.infer.staging import Upload

    up = Upload("cpu")
    host = torch.arange(12, dtype=torch.int64)
    out = up(host)
    assert torch.equal(out, host) and up.slots == [None, None]
