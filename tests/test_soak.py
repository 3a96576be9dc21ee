"""Robustness/soak scenarios: mixed rates, dropouts, hunter engagement,
and a deterministic regression fixture."""

import json

import numpy as np
import pytest

from aero_tpu.channelizer import load_ini
from aero_tpu.runtime.station import Station
from aero_tpu.models.msk import MskDemodulator, msk_modulate
from aero_tpu.protocol.framing import build_p_frames, PChannelFramer
from aero_tpu.protocol.crc import append_crc16_bytes
from aero_tpu.protocol.isu import make_acars_userdata, segment_isu
from aero_tpu.protocol.su_dispatch import PChannelSUDispatcher
from aero_tpu.io.output import to_output_format
from aero_tpu.synth import msk_wideband


def _acars_fields(msg, aes, nsu_per_field=6):
    ud = make_acars_userdata("2", "N1MIX", "!", "H1", "A", msg)
    sus = [append_crc16_bytes(b) for b in segment_isu(ud, aes, 0x41)]
    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    while len(sus) % nsu_per_field:
        sus.append(fill)
    return [b"".join(sus[i:i + nsu_per_field])
            for i in range(0, len(sus), nsu_per_field)]


def test_station_mixed_rates():
    """600 and 1200 bps VFOs in one station (two bank groups)."""
    fs, center = 288000, 1545000000
    ini = (f"sample_rate={fs}\ncenter_frequency={center}\n[vfos]\nsize=2\n"
           f"1\\frequency=1545009000\n1\\data_rate=1200\n1\\topic=A\n1\\gain=100\n"
           f"2\\frequency=1545030000\n2\\data_rate=600\n2\\topic=B\n2\\gain=100\n")
    cfg = load_ini(ini, is_text=True)
    rng = np.random.default_rng(8)

    f1 = _acars_fields("MIXED RATE 1200", 0x111111)
    f2 = _acars_fields("MIXED RATE 600", 0x222222)
    s1 = msk_wideband(build_p_frames(f1, 1200, lead_frames=3), fs, 1200.0,
                      1545009000 + 1000 - center)
    s2 = msk_wideband(build_p_frames(f2, 600, lead_frames=3), fs, 600.0,
                      1545030000 + 1000 - center)
    n = max(len(s1), len(s2)) + 4 * fs
    wb = np.zeros(n, np.complex64)
    wb[: len(s1)] += s1
    wb[: len(s2)] += s2
    wb += (rng.normal(0, 0.004, n) + 1j * rng.normal(0, 0.004, n)).astype(np.complex64)

    got = {}
    st = Station(cfg, on_acars=lambda t, item: got.setdefault(t, item.message))
    B = cfg.buflen_complex
    for i in range(len(wb) // B):
        st.process(wb[i * B:(i + 1) * B])
    assert got == {"A": "MIXED RATE 1200", "B": "MIXED RATE 600"}


def test_dropout_and_relock_long():
    """Signal -> silence -> different CFO -> signal again; both halves decode."""
    rng = np.random.default_rng(9)
    fields1 = _acars_fields("BEFORE DROP", 0x0A0A0A)
    fields2 = _acars_fields("AFTER RELOCK", 0x0B0B0B)
    a1 = msk_modulate(build_p_frames(fields1, 1200, lead_frames=4), 24000,
                      1200, freq=1000.0)
    a2 = msk_modulate(build_p_frames(fields2, 1200, lead_frames=4), 24000,
                      1200, freq=1180.0)
    sig = np.concatenate([a1, np.zeros(48000, np.float32), a2,
                          np.zeros(48000, np.float32)])
    p = np.mean(a1 ** 2)
    sig = (sig + rng.normal(0, np.sqrt(p / 10 ** 1.2), len(sig))).astype(np.float32)

    dm = MskDemodulator(24000, 1200)
    msgs = []
    disp = PChannelSUDispatcher(on_acars=lambda it: msgs.append(it.message))
    fr = PChannelFramer(1200)
    outs = dm.process(sig)
    soft = np.concatenate([o["soft_bits"] for o in outs]).astype(np.float32)
    for ev in fr.feed(soft):
        for k, ok in enumerate(ev.su_crc_ok):
            if ok:
                disp.dispatch(ev.infofield[k * 12:(k + 1) * 12])
    assert "BEFORE DROP" in msgs
    assert "AFTER RELOCK" in msgs


EXPECTED_FIXTURE = {
    "reg": "N7REG", "label": "H1",
    "msg_text": "REGRESSION FIXTURE PAYLOAD 0123456789",
    "src": "ABC123",
}


def test_regression_fixture_jsondump():
    """Deterministic capture -> exact jsondump fields.  Guards every layer
    (modulator, demod, framing, SU dispatch, ACARS parse, output) at once —
    the recorded-IQ regression test of SURVEY.md §4(c)."""
    rng = np.random.default_rng(1234)
    ud = make_acars_userdata("2", "N7REG", "!", "H1", "A",
                             EXPECTED_FIXTURE["msg_text"])
    sus = [append_crc16_bytes(b) for b in segment_isu(ud, 0xABC123, 0x41)]
    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    while len(sus) % 6:
        sus.append(fill)
    fields = [b"".join(sus[i:i + 6]) for i in range(0, len(sus), 6)]
    audio = msk_modulate(build_p_frames(fields, 1200, lead_frames=4),
                         24000, 1200, freq=1077.0)
    p = np.mean(audio ** 2)
    audio = (audio + rng.normal(0, np.sqrt(p / 10 ** 1.5), len(audio))).astype(np.float32)

    dm = MskDemodulator(24000, 1200)
    items = []
    disp = PChannelSUDispatcher(on_acars=items.append)
    fr = PChannelFramer(1200)
    outs = dm.process(np.concatenate([audio, np.zeros(32000, np.float32)]))
    soft = np.concatenate([o["soft_bits"] for o in outs]).astype(np.float32)
    for ev in fr.feed(soft):
        for k, ok in enumerate(ev.su_crc_ok):
            if ok:
                disp.dispatch(ev.infofield[k * 12:(k + 1) * 12])

    assert len(items) == 1
    j = json.loads(to_output_format("jsondump", "FIXTURE", False, items[0],
                                    now=1700000000.0))
    acars = j["isu"]["acars"]
    assert acars["reg"] == EXPECTED_FIXTURE["reg"]
    assert acars["label"] == EXPECTED_FIXTURE["label"]
    assert acars["msg_text"] == EXPECTED_FIXTURE["msg_text"]
    assert j["isu"]["dst"]["addr"] == EXPECTED_FIXTURE["src"]


def test_fused_everything_at_once_with_restart():
    """Interaction soak for the round-4 features together: one
    FusedStation with batched host framing AND hunting runs a mixed
    stream — an on-tune 1200 carrier, a 600 carrier 1500 Hz OFF-center
    that only the hunter can find, and a mid-stream T burst — with a
    checkpoint/restore into a fresh process halfway through.  Every
    message must decode across the restart."""
    from scipy.signal import firwin, lfilter
    from aero_tpu.runtime.fused_station import FusedStation
    from aero_tpu.models.msk import msk_modulate as mod
    from aero_tpu.protocol.rt_framing import build_t_burst

    fs, center = 288000, 1545000000
    ini = (f"sample_rate={fs}\ncenter_frequency={center}\n[vfos]\nsize=3\n"
           f"1\\frequency={center + 24000}\n1\\data_rate=1200\n1\\topic=ON\n"
           f"2\\frequency={center - 24000}\n2\\data_rate=600\n2\\topic=OFF\n"
           f"3\\frequency={center + 60000}\n3\\data_rate=600\n3\\topic=BR\n"
           "3\\burst=1\n")
    cfg = load_ini(ini, is_text=True)

    def up_wb(audio, fsa, delta, dur):
        u = fs // fsa
        x = np.zeros(len(audio) * u, np.float32)
        x[::u] = np.asarray(audio) * u
        bb = lfilter(firwin(511, 1.0 / u), 1.0, x).astype(np.complex64)
        t = np.arange(len(bb)) / fs
        w = (bb * np.exp(2j * np.pi * delta * t)).astype(np.complex64)
        out = np.zeros(dur, np.complex64)
        out[: min(len(w), dur)] = w[:dur]
        return out

    rng = np.random.default_rng(31)
    dur = 14 * fs
    wb = np.zeros(dur, np.complex64)
    # ON: on-tune 1200, repeating
    f_on = _acars_fields("SOAK ON TUNE", 0x111111)
    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    while len(f_on[-1]) < 72:
        f_on[-1] += fill
    bits_on = build_p_frames(f_on * 8, 1200, lead_frames=3)
    wb += up_wb(mod(bits_on, 24000, 1200.0, freq=1000.0), 24000, 24000, dur)
    # OFF: 600 bps at 2500 Hz audio (outside lockingbw of the 1000 tune)
    f_off = _acars_fields("SOAK HUNTED", 0x222222)
    bits_off = build_p_frames(f_off * 5, 600, lead_frames=3)
    wb += up_wb(mod(bits_off, 12000, 600.0, freq=2500.0), 12000, -24000, dur)
    # BR: one T burst arriving in the second half (after the restart)
    bsus = segment_isu(make_acars_userdata("2", "NSOAK", "!", "H1", "A",
                                           "SOAK BURST"), 0x333333, 0x41)
    bt = build_t_burst(0x333333, 0x41, bsus, preamble_bits=96)
    burst_audio = np.concatenate([np.zeros(8 * 12000, np.float32),
                                  mod(bt, 12000, 600.0, freq=3000.0) * 1.6])
    wb += up_wb(burst_audio, 12000, 60000, dur)
    wb += (rng.normal(0, 0.003, dur)
           + 1j * rng.normal(0, 0.003, dur)).astype(np.complex64)

    def mk(sink):
        return FusedStation(cfg, ingest_dtype="int16", hunt_max_tries=2,
                            batch_host_framing=True,
                            on_acars=lambda v, it: sink.append(
                                (v, it.message)))

    w = np.concatenate([wb, np.zeros(3 * 96000, np.complex64)])
    got = []
    st = mk(got)
    blocks = [w[i:i + st.block_len]
              for i in range(0, (len(w) // st.block_len) * st.block_len,
                             st.block_len)]
    half = len(blocks) // 2
    for b in blocks[:half]:
        st.process(b)
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "soak.npz")
        st.save_checkpoint(ck)
        st2 = mk(got)
        st2.load_checkpoint(ck)
        for b in blocks[half:]:
            st2.process(b)
        st2.flush()

    texts = {m for _, m in got}
    assert "SOAK ON TUNE" in texts, sorted(texts)
    assert "SOAK HUNTED" in texts, sorted(texts)
    assert "SOAK BURST" in texts, sorted(texts)
    # hunter state survived the restart and sits near the real carrier
    tel = st2.vfo_telemetry()
    assert abs(tel["OFF"]["freq"] - 2500.0) < 200.0, tel["OFF"]
    assert tel["BR"]["packets"] >= 1
