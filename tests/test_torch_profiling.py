"""The port's profiling tool: the parts that need no device."""

import pytest

from vda_tpu_torch.utils import profiling


@pytest.mark.parametrize("name,kind", [
    ("void vda::(anonymous namespace)::attention_qkv_kernel<__nv_bfloat16, "
     "64>(...)", "K1 attention_qkv"),
    ("void vda::(anonymous namespace)::attention_qkv_bf16_kernel<64>(...)",
     "K1 attention_qkv"),
    ("void vda::sm90::attention_sm90_kernel<vda::sm90::Config<128, 3, 2, "
     "false, false, (vda::sm90::Mode)0, 0, true> >(CUtensorMap_st, ...)",
     "K1 attention_qkv"),
    ("void vda::sm90::attention_heads_sm90_kernel<vda::sm90::HeadsConfig<3, "
     "128, 1, true, 64, 2, (vda::sm90::Phases)0, 2, 1, false> >(...)",
     "K7 attention_proj"),
    ("_ln_fwd", "K2 layer_norm"),
    ("void vda::(anonymous namespace)::temporal_block_kernel<float>(...)",
     "K3 temporal_block"),
    ("void vda::(anonymous namespace)::attention_block_kernel<float>(...)",
     "K4 attention_block"),
    # the Hopper chain of K3/K4: its products on the GEMM mainloop, its
    # attention and LN passes, each tagged with its kernel
    ("void vda::gemm90::gemm_sm90_kernel<vda::gemm90::Config<128, 256, 4, "
     "true, 2, (vda::gemm90::Mode)0, 2>, vda::gemm90::BF16, "
     "vda::gemm::QkvStore<vda::gemm::TemporalK4> >(CUtensorMap_st, ...)",
     "K4 attention_block"),
    ("void vda::gemm90::gemm_sm90_kernel<vda::gemm90::Config<128, 256, 4, "
     "true, 2, (vda::gemm90::Mode)0, 2>, vda::gemm90::BF16, "
     "vda::gemm::Residual<vda::gemm::TemporalK4> >(CUtensorMap_st, ...)",
     "K4 attention_block"),
    ("void vda::gemm90::gemm_sm90_kernel<vda::gemm90::Config<128, 256, 4, "
     "true, 2, (vda::gemm90::Mode)0, 2>, vda::gemm90::BF16, "
     "vda::gemm::Geglu<vda::gemm::TemporalK3> >(CUtensorMap_st, ...)",
     "K3 temporal_block"),
    # K3's fused Hopper kernel
    ("void vda::temporal_fused::temporal_fused_kernel<vda::temporal_fused::"
     "Config<3, 2> >(vda::temporal_fused::Maps, vda::temporal_fused::Params)",
     "K3 temporal_block"),
    ("void vda::temporal::seq_attention_kernel<vda::gemm::TemporalK3, 32>"
     "(const __nv_bfloat16 *, ...)", "K3 temporal_block"),
    ("void vda::temporal::seq_attention_kernel<vda::gemm::TemporalK4, 128>"
     "(const __nv_bfloat16 *, ...)", "K4 attention_block"),
    ("void vda::temporal::ln_ape_kernel<vda::gemm::TemporalK3, 1>(...)",
     "K3 temporal_block"),
    ("void vda::temporal::ln_ape_kernel<vda::gemm::TemporalK4, 4>(...)",
     "K4 attention_block"),
    ("void vda::(anonymous namespace)::tiny_seq_kernel<__nv_bfloat16, 32>"
     "(...)", "K5 tiny_seq"),
    # K5's and K8's Hopper code
    ("void vda::tiny90::tiny90_kernel<8, 32, (vda::tiny90::Mode)0>"
     "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 *, ...)",
     "K5 tiny_seq"),
    ("void vda::tiny90::tiny1_kernel<1, (vda::tiny90::Mode)0>(const "
     "__nv_bfloat16 *, ...)", "K5 tiny_seq"),
    ("void vda::seg90::segment90_kernel<vda::seg90::Config<64, 6, "
     "(vda::seg90::Mode)0> >(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "__nv_bfloat16 *, const int4 *, int, int, float, int)",
     "K8 segment_attention"),
    ("void vda::(anonymous namespace)::segment_bf16_kernel<64>(...)",
     "K8 segment_attention"),
    ("void vda::(anonymous namespace)::segment_f32_kernel<16>(...)",
     "K8 segment_attention"),
    ("void vda::(anonymous namespace)::stream_kv_kernel<float>(...)",
     "K6 stream_kv"),
    ("void vda::stream90::kv_loop_kernel<16, 0>(vda::stream90::Args)",
     "K6 stream_kv"),
    ("void vda::resize90::resize90_kernel<128, 0>(vda::resize90::Args)",
     "K10 resize_bilinear"),
    ("void vda::(anonymous namespace)::attention_proj_bf16_kernel<64>(...)",
     "K7 attention_proj"),
    ("void vda::(anonymous namespace)::resize_bilinear_kernel(...)",
     "K10 resize_bilinear"),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_"
     "impl_nocast<at::native::direct_copy_kernel_cuda(...)", "copy"),
    ("Memcpy HtoD (Pageable -> Device)", "copy"),
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw",
     "conv (cuDNN)"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT", "gemm (cuBLAS)"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::"
     "GeluCUDAKernelImpl(...)", "elementwise"),
    ("void at::native::reduce_kernel<512, 1>(...)", "reduction"),
    ("something_else", "other"),
])
def test_kernel_kind(name, kind):
    assert profiling.kernel_kind(name) == kind


@pytest.mark.parametrize("intervals,ms", [
    ([], 0.0),
    ([(0, 1000)], 1.0),
    ([(0, 1000), (500, 1500)], 1.5),            # overlapping
    ([(2000, 3000), (0, 1000)], 2.0),           # disjoint, out of order
    ([(0, 3000), (1000, 2000), (2500, 4000)], 4.0),  # nested then extended
])
def test_busy_ms_is_the_union_of_intervals(intervals, ms):
    assert profiling.busy_ms(intervals) == pytest.approx(ms)


def test_layers_from_device_spans():
    spans = [{"name": n, "device_ms": v} for n, v in (
        ("forward", 20.0), ("encoder", 8.0), ("head.stage", 6.0),
        ("head.project_resize", 1.0), ("head.temporal_mm0", 1.0),
        ("head.temporal_mm1", 1.0), ("head.temporal_mm2", 0.5),
        ("head.temporal_mm3", 0.5), ("head.tail", 4.0),
        ("head.output_tail", 1.5), ("head.output_tail", 1.5),
        ("window.upload", None))] * 2
    ms = profiling._layers(profiling._device_ms(spans, 2), "forward",
                           "forward")
    assert ms["forward"] == 20.0 and ms["encoder"] == 8.0
    assert ms["head"] == 10.0 and ms["head.output_tail"] == 3.0
    assert ms["head.rest"] == pytest.approx(10.0 - 7.0)


def test_layer_times_keys_and_no_patching(monkeypatch):
    """The JSON keys of the ``layers`` phase, from the port's own spans on
    the CPU (no device time there: every layer reads 0), and no attribute
    of the port is set."""
    import inspect

    import torch

    import vda_tpu_torch as vt

    assert "setattr" not in inspect.getsource(profiling)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    model = vt.init_random(vt.get_config("tiny"),
                           torch.Generator().manual_seed(0),
                           device="cpu").requires_grad_(False)
    ms = profiling.layer_times(model, torch.rand(1, 4, 56, 56, 3), reps=1)
    assert sorted(ms) == sorted(
        ["encoder", "head", "head.project_resize", "head.temporal_mm0",
         "head.temporal_mm1", "head.temporal_mm2", "head.temporal_mm3",
         "head.output_tail", "head.rest", "forward", "forward.rest"])
    assert set(ms.values()) == {0.0}
