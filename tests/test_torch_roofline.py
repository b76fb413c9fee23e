"""The port's roofline (``repro_torch.roofline``) and input shapes
(``configs/shapes.py``) against the JAX package's, and each kernel's work
counts against the bounds ``PERF.md`` records for them.

Only JAX-free modules of the reference are imported here:
``repro.configs.shapes`` and ``repro.roofline.analysis`` (which imports
``hlo_parse`` and ``hw``, stdlib only). ``repro.launch.dryrun`` and
``repro.roofline.rescore`` set ``XLA_FLAGS`` when imported, which would
give every JAX test of an xdist worker hundreds of CPU devices; neither
is imported.
"""
import json

import pytest

from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.roofline import analysis as janalysis
from repro_torch.configs import registry, shapes
from repro_torch.roofline import analysis, hw, kernels, report

CELLS = [(a, s) for a in registry.ARCH_NAMES for s in shapes.SHAPES]


def test_shapes_are_the_references():
    assert shapes.SHAPES.keys() == jshapes.SHAPES.keys()
    for name, spec in shapes.SHAPES.items():
        want = jshapes.SHAPES[name]
        assert (spec.name, spec.seq_len, spec.global_batch, spec.kind) == \
            (want.name, want.seq_len, want.global_batch, want.kind)
    assert shapes.LONG_OK == jshapes.LONG_OK
    for a, s in CELLS:
        assert shapes.applicable(a, s) == jshapes.applicable(a, s)
    assert shapes.cells(registry.ARCH_NAMES) == \
        jshapes.cells(jreg.ARCH_NAMES)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("arch", registry.ARCH_NAMES)
def test_model_flops_and_napkin_bytes_are_the_references(arch):
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    for name in shapes.SHAPES:
        shape, jshape = shapes.SHAPES[name], jshapes.SHAPES[name]
        for last in (False, True):
            assert _rel(analysis.model_flops(cfg, shape, last_logits=last),
                        janalysis.model_flops(jcfg, jshape,
                                              last_logits=last)) <= 1e-12
        for ring in (False, True):
            for each in (4.0, 2.0):
                assert _rel(
                    analysis.napkin_bytes(cfg, shape, ring_cache=ring,
                                          param_bytes_each=each),
                    janalysis.napkin_bytes(jcfg, jshape, ring_cache=ring,
                                           param_bytes_each=each)) <= 1e-12


def test_roofline_terms_over_the_h100():
    cfg, shape = registry.get_config("qwen3-1.7b"), shapes.SHAPES["train_4k"]
    traced = {"flops": 1e18, "bytes": 2e15,
              "collective": {"total": 3e13}}
    r = analysis.analyze("qwen3-1.7b", "train_4k", "single", chips=256,
                         traced=traced, cfg=cfg, shape=shape,
                         bytes_per_device=1.0)
    assert r.hlo_flops == r.hlo_flops_raw == 1e18
    assert r.t_compute == pytest.approx(1e18 / (256 * 989e12), rel=1e-12)
    assert r.t_memory == pytest.approx(
        analysis.napkin_bytes(cfg, shape) / (256 * 3.35e12), rel=1e-12)
    assert r.t_memory_hlo_upper == pytest.approx(2e15 / (256 * 3.35e12),
                                                 rel=1e-12)
    assert r.t_collective == pytest.approx(3e13 / (256 * 450e9), rel=1e-12)
    assert r.bottleneck == "compute"
    assert set(r.to_json()) == set(janalysis.Roofline.__dataclass_fields__)
    again = analysis.rescore(r.to_json())
    assert again["t_compute"] == r.t_compute
    assert again["t_memory"] == r.t_memory


def test_hw_holds_the_h100_data_sheet():
    assert (hw.PEAK_FLOPS_BF16, hw.PEAK_FLOPS_TF32, hw.PEAK_FLOPS_F32,
            hw.PEAK_FLOPS_F64, hw.HBM_BW, hw.HBM_BYTES, hw.NVLINK_BW,
            hw.SMS) == (989e12, 495e12, 67e12, 34e12, 3.35e12, 80e9,
                        450e9, 132)


# The bounds PERF.md section 6 prints, to the digits it prints them.
def _ssd(BC):
    fn, _ = kernels.ssd_flops(BC, 256, 24, 64, 128)
    return kernels.bound_ms(kernels.ssd_bytes(BC, 256, 24, 64, 128), 3 * fn,
                            hw.PEAK_FLOPS_TF32)


def _ssd_bwd(BC):
    return kernels.bound_ms(kernels.ssd_bwd_bytes(BC, 256, 24, 64, 128),
                            3 * kernels.ssd_bwd_flops(BC, 256, 24, 64, 128),
                            hw.PEAK_FLOPS_TF32)


BOUNDS = {
    "ssd forward BC=64": (lambda: _ssd(64), 4, 0.0815),
    "flash forward prefill": (lambda: kernels.bound_ms(
        kernels.flash_bytes(4, 16, 8, 4096, 4096, 128),
        kernels.flash_flops(4, 16, 4096, 4096, 128, True),
        hw.PEAK_FLOPS_BF16), 3, 0.278),
    "xcov_diag n=256": (lambda: kernels.bound_ms(
        kernels.xcov_bytes(256, 2048, 5, True),
        3 * kernels.xcov_flops(256, 2048), hw.PEAK_FLOPS_TF32), 4, 0.0130),
    "downdate f32": (lambda: kernels.bound_ms(
        kernels.downdate_bytes(2048, 1600, 4),
        kernels.downdate_flops(2048, 1600), hw.PEAK_FLOPS_F32), 3, 0.300),
    "downdate f64": (lambda: kernels.bound_ms(
        kernels.downdate_bytes(2048, 1600, 8),
        kernels.downdate_flops(2048, 1600), hw.PEAK_FLOPS_F64), 3, 0.592),
    "flash backward training": (lambda: kernels.bound_ms(
        kernels.flash_bwd_bytes(2, 16, 8, 4096, 128),
        kernels.flash_bwd_flops(2, 16, 4096, 128), hw.PEAK_FLOPS_BF16),
        4, 0.3475),
    "ssd backward BC=128": (lambda: _ssd_bwd(128), 4, 0.3326),
}


@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_kernel_bounds_are_perf_md_s(name):
    fn, digits, want = BOUNDS[name]
    ms, by = fn()
    assert by == "operations"
    assert round(ms, digits) == want


def test_kernel_counts_by_hand():
    # a 2 x 3 causal attention head of D = 4: 3 pairs, 4 D a pair
    assert kernels.flash_flops(1, 1, 2, 2, 4, True) == 4 * 4 * 3
    assert kernels.flash_flops(1, 1, 2, 3, 4, False) == 4 * 4 * 6
    with pytest.raises(ValueError):
        kernels.attention_pairs(2, 3, True)
    assert kernels.rbf_flops(10, 5) == 10 * 16
    assert kernels.rbf_bytes(2, 3, 6, 5) == (10 + 15 + 6) * 4
    assert kernels.icf_flops(8, 3) == 8 * 3 * 2
    assert kernels.downdate_flops(4, 2) == 3 * 2 * 4 * 3
    ms, by = kernels.bound_ms(3.35e9, 1.0)
    assert (round(ms, 9), by) == (1.0, "bytes")


def test_report_renders_a_fixed_record_set(tmp_path):
    recs = {
        "qwen3-1.7b_train_4k_single": dict(
            status="ok", arch="qwen3-1.7b", shape="train_4k", mesh="single",
            chips=256, t_compute=0.0545, t_memory=0.0057, t_collective=2.5,
            bottleneck="collective", useful_fraction=0.8928,
            roofline_fraction=0.0194),
        "qwen3-1.7b_long_500k_single": dict(status="skip", reason="x"),
        "qwen3-1.7b_train_4k_multi": dict(
            status="ok", arch="qwen3-1.7b", shape="train_4k", mesh="multi",
            chips=512, t_compute=1e-5, t_memory=1e-5, t_collective=1e-5,
            bottleneck="compute", useful_fraction=1.0,
            roofline_fraction=1.0),
        "olmo-1b_decode_32k_single": dict(status="fail", error="x"),
    }
    for name, rec in recs.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
    assert report.table(tmp_path, "single").splitlines() == [
        "| arch | shape | chips | t_compute | t_memory | t_coll | "
        "bottleneck | useful | roofline |",
        "|---|---|---|---|---|---|---|---|---|",
        "| qwen3-1.7b | long_500k | - | - | - | - | SKIP (sub-quadratic "
        "rule) | - | - |",
        "| qwen3-1.7b | train_4k | 256 | 54.5ms | 5.7ms | 2.50s | "
        "collective | 0.89 | 0.019 |"]
    assert report.fmt_s(None) == "-"
    assert report.fmt_s(2e-5) == "20us"
