"""Station full-chain test: wideband -> channelizer -> batched VFO bank ->
deframers -> ACARS, multiple VFOs concurrently."""

import numpy as np

from aero_tpu.channelizer import load_ini
from aero_tpu.runtime.station import Station
from aero_tpu.protocol.framing import build_p_frames
from aero_tpu.protocol.crc import append_crc16_bytes
from aero_tpu.protocol.isu import make_acars_userdata, segment_isu
from aero_tpu.synth import msk_wideband


def test_station_two_vfos():
    fs, center = 288000, 1545000000
    rfs = [1545009000, 1545030000]
    ini = f"sample_rate={fs}\ncenter_frequency={center}\n[vfos]\nsize=2\n" + \
        "".join(f"{i+1}\\frequency={rf}\n{i+1}\\data_rate=1200\n"
                f"{i+1}\\topic=V{i+1}\n{i+1}\\gain=100\n"
                for i, rf in enumerate(rfs))
    cfg = load_ini(ini, is_text=True)

    rng = np.random.default_rng(5)
    wb = None
    msgs = {}
    for i, rf in enumerate(rfs):
        ud = make_acars_userdata("2", f"N{i}STA", "!", "H1", "A",
                                 f"STATION MSG {i}")
        sus = [append_crc16_bytes(b) for b in segment_isu(ud, 0x200000 + i, 0x41)]
        fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
        while len(sus) % 6:
            sus.append(fill)
        fields = [b"".join(sus[j:j + 6]) for j in range(0, len(sus), 6)]
        bits = build_p_frames(fields, 1200, lead_frames=3 + i)
        s = msk_wideband(bits, fs, 1200.0, (rf + 1000) - center)
        if wb is None:
            wb = np.zeros(len(s) + 3 * fs, np.complex64)
        wb[:len(s)] += s.astype(np.complex64)
        msgs[f"V{i+1}"] = f"STATION MSG {i}"
    wb += (rng.normal(0, 0.005, len(wb))
           + 1j * rng.normal(0, 0.005, len(wb))).astype(np.complex64)

    got = {}
    st = Station(cfg, on_acars=lambda t, item: got.setdefault(t, item.message))
    B = cfg.buflen_complex
    for i in range(len(wb) // B):
        st.process(wb[i * B:(i + 1) * B])

    assert got == msgs
    assert st.stats.acars == 2
    assert st.stats.su_ok > 0


def test_station_mixed_continuous_and_burst():
    """One wideband: a continuous 1200 P-channel VFO + a burst 600 R/T VFO
    (aero-tpu INI extension 'burst=1')."""
    from aero_tpu.protocol.rt_framing import build_t_burst

    fs, center = 288000, 1545000000
    ini = (f"sample_rate={fs}\ncenter_frequency={center}\n[vfos]\nsize=2\n"
           f"1\\frequency=1545009000\n1\\data_rate=1200\n1\\topic=P\n1\\gain=100\n"
           f"2\\frequency=1545030000\n2\\data_rate=600\n2\\topic=R\n"
           f"2\\gain=100\n2\\burst=1\n")
    cfg = load_ini(ini, is_text=True)
    assert cfg.subs[1].burst
    rng = np.random.default_rng(4)

    udp = make_acars_userdata("2", "N1CONT", "!", "H1", "A", "CONTINUOUS MSG")
    sus = [append_crc16_bytes(b) for b in segment_isu(udp, 0x111111, 0x41)]
    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    while len(sus) % 6:
        sus.append(fill)
    fields = [b"".join(sus[j:j + 6]) for j in range(0, len(sus), 6)]
    s1 = msk_wideband(build_p_frames(fields, 1200, lead_frames=3), fs,
                      1200.0, 9000 + 1000)
    sus2 = segment_isu(make_acars_userdata("2", "N2BRST", "!", "H1", "A",
                                           "BURST IN STATION"),
                       0x222222, 0x41)
    bt = build_t_burst(0x222222, 0x41, sus2, preamble_bits=96)
    s2 = msk_wideband(bt, fs, 600.0, 30000 + 3000) * 1.6
    pad = fs
    n = max(len(s1), pad + len(s2)) + 4 * fs
    wb = np.zeros(n, np.complex64)
    wb[: len(s1)] += s1.astype(np.complex64)
    wb[pad: pad + len(s2)] += s2.astype(np.complex64)
    wb += (rng.normal(0, 0.003, n) + 1j * rng.normal(0, 0.003, n)).astype(np.complex64)

    got = {}
    st = Station(cfg, on_acars=lambda t, item: got.setdefault(t, item.message))
    B = cfg.buflen_complex
    for i in range(len(wb) // B):
        st.process(wb[i * B:(i + 1) * B])
    assert got == {"P": "CONTINUOUS MSG", "R": "BURST IN STATION"}


def test_fused_station_decodes_end_to_end():
    """Device-resident station: one jit call per block, int16 ingest."""
    import numpy as np
    from scipy.signal import firwin, lfilter
    from aero_tpu.channelizer import load_ini
    from aero_tpu.runtime.fused_station import FusedStation
    from aero_tpu.models.msk import msk_modulate
    from aero_tpu.protocol.framing import build_p_frames
    from aero_tpu.protocol.crc import append_crc16_bytes
    from aero_tpu.protocol.isu import make_acars_userdata, segment_isu

    B = 4
    vfos = "".join(
        f"{i+1}\\frequency={1545002000 + i*19000}\n{i+1}\\data_rate=1200\n"
        f"{i+1}\\topic=V{i}\n{i+1}\\gain=100\n" for i in range(B))
    ini = (f"[General]\nsample_rate=1536000\ncenter_frequency=1545000000\n"
           f"[vfos]\nsize={B}\n{vfos}")
    cfg = load_ini(ini, is_text=True)

    ud = make_acars_userdata("2", "VH-FUS", "!", "AA", "M", "FUSED OK")
    sus = [append_crc16_bytes(b) for b in segment_isu(ud, 0x654321, 0x41)]
    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    while len(sus) % 6:
        sus.append(fill)
    fields = [b"".join(sus[i:i + 6]) for i in range(0, len(sus), 6)]
    bits = build_p_frames(fields, 1200, lead_frames=6)
    audio = np.asarray(msk_modulate(bits, 24000, 1200, freq=1000.0))
    up = np.zeros(len(audio) * 64, np.float32)
    up[::64] = audio * 64
    bb = lfilter(firwin(511, 1.0 / 64), 1.0, up).astype(np.float32)
    delta = (1545002000 + 2 * 19000) - 1545000000
    t = np.arange(len(bb)) / 1536000.0
    wide = (bb * np.exp(2j * np.pi * delta * t)).astype(np.complex64)

    # int16 pair ingest, packed-nibble int4 (the reference's own IQ
    # compress style, vfo.cpp:262-275) and 2-bit sign-magnitude int2 must
    # all decode end to end; int4 also runs multi-block dispatch (one
    # lax.scan step + one fetch per 2 blocks)
    for ingest, m in (("int16", 1), ("int4", 2), ("int2", 1)):
        msgs = []
        st = FusedStation(cfg, ingest_dtype=ingest, blocks_per_step=m,
                          on_acars=lambda v, item: msgs.append(
                              (v, item.message)))
        w = np.concatenate([wide, np.zeros(2 * st.block_len, np.complex64)])
        n = (len(w) // st.block_len) * st.block_len
        v2_locked = False
        for i in range(0, n, st.block_len):
            st.process(w[i:i + st.block_len])
            tel = st.vfo_telemetry()
            if tel:
                assert set(tel) == {f"V{k}" for k in range(B)}
                if tel["V2"]["signal"] and tel["V2"]["mse"] < 0.5:
                    v2_locked = True
        st.flush()
        assert ("V2", "FUSED OK") in msgs, ingest
        assert st.stats.su_ok > 0
        assert v2_locked, "per-VFO telemetry never showed V2 locked"


def test_station_full_54w_bank_capacity():
    """BASELINE.md capacity target: the full 54W L-band VFO bank (26
    channels, configs/aor_w_54_lband.ini) runs in ONE station process —
    the reference needs 26 aero-decode processes.  A live MSK 1200
    signal on VFO08 decodes while the whole bank is channelized."""
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "aor_w_54_lband.ini")
    cfg = load_ini(path)
    assert len(cfg.subs) == 26
    assert sum(1 for s in cfg.subs if s.burst) == 2
    fs = cfg.sample_rate

    ud = make_acars_userdata("2", "N54W", "!", "AA", "A", "FULL BANK")
    sus = [append_crc16_bytes(b) for b in segment_isu(ud, 0x543210, 0x41)]
    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    while len(sus) % 6:
        sus.append(fill)
    fields = [b"".join(sus[j:j + 6]) for j in range(0, len(sus), 6)]
    # VFO08 sits at 1545.120 MHz; center is 1545.200 MHz -> -80 kHz,
    # plus the usual +1 kHz audio offset (the USB-demod channel puts the
    # carrier above DC, exactly like the reference's SDRReceiver setup)
    s = msk_wideband(build_p_frames(fields, 1200, lead_frames=3), fs,
                     1200.0, -80000 + 1000) * 20.0
    rng = np.random.default_rng(54)
    n = len(s) + fs
    wb = np.zeros(n, np.complex64)
    wb[: len(s)] += s.astype(np.complex64)
    wb += (rng.normal(0, 0.003, n) + 1j
           * rng.normal(0, 0.003, n)).astype(np.complex64)

    got = {}
    st = Station(cfg, on_acars=lambda t, item: got.setdefault(t, item.message))
    B = cfg.buflen_complex
    for i in range(len(wb) // B):
        st.process(wb[i * B:(i + 1) * B])
    assert got.get("VFO08") == "FULL BANK", got
    assert st.stats.wideband_samples == (len(wb) // B) * B
