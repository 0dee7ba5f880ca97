"""The port's analytic cost model (``repro_torch.launch.roofline``)
against the JAX package's: every function equal, to the last bit, for
the ten ``full()`` configs and the three variants, in each mode, at two
shapes and two chip counts; and the peaks are the H100's data sheet's.
"""
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402

ARCHS = list(configs.ALIASES) + list(configs.VARIANTS)


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_model_equals_reference(arch):
    j, t = jconfigs.get(arch), configs.get(arch)
    assert roofline.active_param_count(t) == jroofline.active_param_count(j)
    assert roofline._total_params(t) == jroofline._total_params(j)
    assert roofline._dtype_bytes(t) == jroofline._dtype_bytes(j)
    for mode in ("train", "prefill", "decode"):
        for seq, batch in ((4096, 8), (1024, 3)):
            for fn in ("analytic_flops", "model_flops"):
                assert getattr(roofline, fn)(t, mode, seq, batch) == \
                    getattr(jroofline, fn)(j, mode, seq, batch), (fn, mode)
            assert roofline.head_flops(t, batch, seq, mode) == \
                jroofline.head_flops(j, batch, seq, mode)
            for chips in (1, 256):
                assert roofline.analytic_bytes(t, mode, seq, batch, chips) \
                    == jroofline.analytic_bytes(j, mode, seq, batch, chips)
        assert roofline.forward_flops(t, 2, 1, 512) == \
            jroofline.forward_flops(j, 2, 1, 512)


def test_peaks_are_the_h100s():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 450e9
