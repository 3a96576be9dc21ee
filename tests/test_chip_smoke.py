"""chip_smoke.py's checks, run on the CPU: its scoring of decodes and its
refusal to run anywhere but on a GPU."""

from collections import Counter

import pytest

import chip_smoke


def test_compare_decoded_equal_missing_extra():
    want = Counter({("VFO01", "VFO01 MSG 0"): 1, ("RCH01", "RCH01 BURST 0"): 1})
    chip_smoke.compare_decoded(Counter(want), want, "same")
    with pytest.raises(AssertionError, match="missing .*VFO01 MSG 0"):
        chip_smoke.compare_decoded(
            Counter({("RCH01", "RCH01 BURST 0"): 1}), want, "missing")
    # a second decode of one message (e.g. on a neighbouring VFO) is extra
    with pytest.raises(AssertionError, match="extra .*RCH01 BURST 0"):
        chip_smoke.compare_decoded(
            want + Counter({("RCH01", "RCH01 BURST 0"): 1}), want, "extra")


def test_refuses_a_device_that_is_not_a_gpu():
    import jax
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu([])


def test_jsondump_scoring_maps_aes_to_topic():
    """station_main's jsondump carries no VFO name: the smoke scores it
    through the AES address each VFO's traffic was given."""
    from aero_tpu.io.output import to_output_format
    from aero_tpu.protocol.su_dispatch import PChannelSUDispatcher
    from aero_tpu.synth import acars_sus
    items = []
    disp = PChannelSUDispatcher(on_acars=items.append)
    for su in acars_sus(0x540105, "N54S05", "VFO06 MSG 2"):
        disp.dispatch(su)
    line = to_output_format("jsondump", "SMOKE", False, items[0])
    got = chip_smoke.decoded_from_jsondump([line, "not json"],
                                           {0x540105: "VFO06"})
    assert got == Counter({("VFO06", "VFO06 MSG 2"): 1})


def test_bank_ini_drops_main_vfos():
    from aero_tpu.channelizer import load_ini
    cfg = load_ini(chip_smoke.bank_ini_text(), is_text=True)
    assert not cfg.mains and len(cfg.subs) == 26
    assert len(chip_smoke.bank_carriers(cfg)) == 24
