"""Seeded transmit-side generators for end-to-end checks of the station.

The tests and ``chip_smoke.py`` feed the receiver wideband IQ built here
and compare what it decodes with what was injected.  Everything is numpy;
nothing here runs on the device.
"""

from __future__ import annotations

import numpy as np

from aero_tpu.protocol.crc import append_crc16_bytes
from aero_tpu.protocol.framing import build_p_frames, FRAME_SPECS
from aero_tpu.protocol.isu import make_acars_userdata, segment_isu

FILL_SU = append_crc16_bytes(bytes([0x01] + [0] * 9))


def acars_sus(aes: int, reg: str, text: str, label: str = "H1",
              ges: int = 0x41) -> list:
    """One ACARS message as 12-byte SUs (CRC appended)."""
    ud = make_acars_userdata("2", reg, "!", label, "A", text)
    return [append_crc16_bytes(b) for b in segment_isu(ud, aes, ges)]


def p_frame_bits(messages, rate: int, lead_frames: int = 2,
                 tail_frames: int = 0) -> np.ndarray:
    """P-channel bit stream with each message in its own infofield.

    ``messages``: list of (aes, reg, text); each message's SUs are padded
    with fill SUs to a whole infofield, so message k rides frame k.
    ``tail_frames`` all-fill frames follow the last message."""
    per = FRAME_SPECS[rate].payload_info_bits // 96    # SUs per infofield
    fields = []
    for aes, reg, text in messages:
        sus = acars_sus(aes, reg, text)
        assert len(sus) <= per, f"message too long for one frame: {text!r}"
        sus += [FILL_SU] * (per - len(sus))
        fields.append(b"".join(sus))
    fields += [FILL_SU * per] * tail_frames
    return build_p_frames(fields, rate, lead_frames=lead_frames)


def p_stream(rate: int, tag: str, lead: int) -> np.ndarray:
    """P-channel bits carrying one ACARS message whose text is ``tag``
    (its SUs may span several infofields)."""
    sus = acars_sus(0x300000, "N" + tag[:5], tag)
    per = FRAME_SPECS[rate].payload_info_bits // 96
    while len(sus) % per:
        sus.append(FILL_SU)
    fields = [b"".join(sus[i:i + per]) for i in range(0, len(sus), per)]
    return build_p_frames(fields, rate, lead_frames=lead)


def msk_wideband(bits, fs: int, fb: int, offset_hz: float,
                 amplitude: float = 0.05, phase0: float = 0.0) -> np.ndarray:
    """Continuous-phase MSK at complex baseband, ``offset_hz`` off the
    wideband center, sampled at ``fs`` (fs/fb must be an integer).

    The differential precoding matches the receiver's MSK convention:
    e[k] = bits[k] ^ e[k-1] ^ (k odd)."""
    sps = int(round(fs / fb))
    assert sps * fb == fs
    bits = np.asarray(bits, np.int64)
    e = np.cumsum(bits + (np.arange(len(bits)) & 1)) & 1
    steps = np.repeat((1 - 2 * e.astype(np.float64)) * (np.pi / 2) / sps, sps)
    ph = phase0 + np.concatenate([[0.0], np.cumsum(steps)])[:-1]
    n = np.arange(len(ph))
    return (amplitude * np.exp(1j * (2 * np.pi * offset_hz / fs * n + ph))
            ).astype(np.complex64)


def to_wideband(audio, fs_audio: int, delta: float, n_total: int,
                fs: int) -> np.ndarray:
    """Real audio at ``fs_audio`` -> complex wideband at ``fs``, centered
    ``delta`` Hz off the wideband center (interpolating lowpass, 511 taps).
    ``n_total`` caps the number of audio samples used."""
    from scipy.signal import firwin, lfilter
    up = fs // fs_audio
    x = np.zeros(n_total * up, np.float32)
    a = np.asarray(audio)[: n_total]
    x[: len(a) * up: up] = a * up
    bb = lfilter(firwin(511, 1.0 / up), 1.0, x).astype(np.complex64)
    t = np.arange(len(bb)) / fs
    return (bb * np.exp(2j * np.pi * delta * t)).astype(np.complex64)


# -- the five-path mixed layout: every channel type in one station --------

MIXED_FS = 288000
MIXED_CENTER = 1545000000
MIXED_TOPICS = {"M600", "M1200", "Q10500", "C8400", "BURST",
                "M600b", "M1200b", "Q10500b", "C8400b", "BURSTb"}
MIXED_ACARS = {("M600", "MIX 600"), ("M1200", "MIX 1200"),
               ("Q10500", "MIX 10500"), ("BURST", "MIX BURST")}


def mixed_ini() -> str:
    """10 VFOs at 288 kS/s, two per rate group (MSK 600/1200, OQPSK
    10500, the OQPSK 8400 C channel, a 600 bps burst watcher), so every
    group is shardable over a 2-device mesh."""
    c = MIXED_CENTER
    return (f"[General]\nsample_rate={MIXED_FS}\ncenter_frequency={c}\n"
            "[vfos]\nsize=10\n"
            f"1\\frequency={c + 6000}\n1\\data_rate=600\n1\\topic=M600\n"
            f"2\\frequency={c + 24000}\n2\\data_rate=1200\n2\\topic=M1200\n"
            f"3\\frequency={c + 48000}\n3\\data_rate=10500\n3\\topic=Q10500\n"
            f"4\\frequency={c + 96000}\n4\\data_rate=8400\n4\\topic=C8400\n"
            f"5\\frequency={c - 30000}\n5\\data_rate=600\n5\\topic=BURST\n"
            "5\\burst=1\n"
            f"6\\frequency={c - 12000}\n6\\data_rate=600\n6\\topic=M600b\n"
            f"7\\frequency={c - 72000}\n7\\data_rate=1200\n7\\topic=M1200b\n"
            f"8\\frequency={c - 110000}\n8\\data_rate=10500\n"
            "8\\topic=Q10500b\n"
            f"9\\frequency={c - 96000}\n9\\data_rate=8400\n9\\topic=C8400b\n"
            f"10\\frequency={c + 72000}\n10\\data_rate=600\n"
            "10\\topic=BURSTb\n10\\burst=1\n")


def mixed_wideband(seed: int = 7, seconds: int = 9):
    """Wideband IQ for ``mixed_ini``: ACARS on one VFO of each P group and
    on the burst watcher, two C-channel frames of voice + signalling, and
    noise.  Returns (iq, cframes) with cframes = [(sus, voice bytes)]."""
    from aero_tpu.models.msk import msk_modulate
    from aero_tpu.models.oqpsk import oqpsk_modulate
    from aero_tpu.protocol.c_framing import build_c_frames
    from aero_tpu.protocol.rt_framing import build_t_burst

    rng = np.random.default_rng(seed)
    cframes = []
    for _ in range(2):
        csus = [append_crc16_bytes(
            bytes([0x30]) + bytes(rng.integers(0, 256, 9,
                                               dtype=np.uint8).tolist()))
            for _ in range(3)]
        voice = bytes(rng.integers(0, 256, 300, dtype=np.uint8).tolist())
        cframes.append((csus, voice))

    bsus = segment_isu(make_acars_userdata("2", "NBURST", "!", "H1", "A",
                                           "MIX BURST"), 0x444444, 0x41)
    bt = build_t_burst(0x444444, 0x41, bsus, preamble_bits=96)

    fs = MIXED_FS
    dur = seconds * fs
    wb = np.zeros(dur, np.complex64)
    wb += to_wideband(msk_modulate(p_stream(600, "MIX 600", 2),
                                   12000, 600.0, freq=1000.0),
                      12000, 6000, dur // 24, fs)
    wb += to_wideband(msk_modulate(p_stream(1200, "MIX 1200", 3),
                                   24000, 1200.0, freq=1000.0),
                      24000, 24000, dur // 12, fs)
    wb += to_wideband(oqpsk_modulate(p_stream(10500, "MIX 10500", 6),
                                     48000, 10500.0, freq=8000.0),
                      48000, 48000, dur // 6, fs)
    wb += to_wideband(oqpsk_modulate(build_c_frames(cframes, lead_frames=3),
                                     48000, 8400, freq=8000.0),
                      48000, 96000, dur // 6, fs)
    burst_audio = np.concatenate(
        [np.zeros(2 * 12000, np.float32),
         msk_modulate(bt, 12000, 600.0, freq=3000.0) * 1.6])
    wb += to_wideband(burst_audio, 12000, -30000, dur // 24, fs)
    wb += (rng.normal(0, 0.003, dur)
           + 1j * rng.normal(0, 0.003, dur)).astype(np.complex64)
    return wb, cframes


# -- the five-path layout at 1.536 MS/s, nv VFOs per rate group ----------

FIVE_PATH_GROUPS = (             # data_rate, first RF, spacing, tag, extra
    ("1200", 1545002000, 19000, "V", ""),
    ("10500", 1545300000, 48000, "Q", ""),
    ("600", 1544800000, 19000, "S", ""),
    ("8400", 1544300000, 96000, "C", ""),
    ("600", 1544600000, 19000, "B", "burst=1"),
)


def five_path_ini(nv: int, fs: int = 1536000,
                  center: int = 1545000000) -> str:
    """All five channel paths with ``nv`` VFOs each (topics V0.., Q0..,
    S0.., C0.., B0..), so every rate group divides an nv-device mesh."""
    vfos = ""
    idx = 0
    for rate, f0, spacing, tag, extra in FIVE_PATH_GROUPS:
        for i in range(nv):
            idx += 1
            vfos += (f"{idx}\\frequency={f0 + i * spacing}\n"
                     f"{idx}\\data_rate={rate}\n{idx}\\topic={tag}{i}\n"
                     f"{idx}\\gain=100\n")
            if extra:
                vfos += f"{idx}\\{extra}\n"
    return (f"[General]\nsample_rate={fs}\ncenter_frequency={center}\n"
            f"[vfos]\nsize={5 * nv}\n{vfos}")
