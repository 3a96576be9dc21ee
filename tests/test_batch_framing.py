"""Batched device-side frame decoding tests."""

import numpy as np
import pytest
import jax.numpy as jnp

from aero_tpu.protocol.batch_framing import (batch_decode_p_frames,
                                             crc16_check_batch)
from aero_tpu.protocol.framing import (build_p_frames, FRAME_SPECS,
                                       bits_to_bytes_lsb)
from aero_tpu.protocol.crc import append_crc16_bytes
from aero_tpu.protocol.interleaver import deinterleave_indices


def test_crc_batch_matches_scalar():
    rng = np.random.default_rng(0)
    sus = [np.unpackbits(np.frombuffer(
        append_crc16_bytes(bytes(rng.integers(0, 256, 10, dtype=np.uint8).tolist())),
        np.uint8), bitorder="little") for _ in range(16)]
    bad = sus[3].copy()
    bad[7] ^= 1
    sus.append(bad)
    ok = np.asarray(crc16_check_batch(jnp.asarray(np.stack(sus))))
    assert ok[:16].all() and not ok[16]


def test_batch_decode_matches_stream():
    rng = np.random.default_rng(1)
    rate = 1200
    spec = FRAME_SPECS[rate]
    fields = [b"".join(append_crc16_bytes(bytes([0x71] + list(rng.integers(0, 256, 9))))
                       for _ in range(6)) for _ in range(6)]
    bits = build_p_frames(fields, rate, lead_frames=1)
    soft = bits.astype(np.float32) * 255
    tb, hb = spec.total_bits, spec.header_bits
    didx = deinterleave_indices(spec.cols)
    payloads, prefixes = [], []
    prev_tail = np.full(62, 128.0, np.float32)
    for j in range(len(bits) // tb):
        pay = soft[j * tb + hb: j * tb + hb + spec.payload_soft_bits]
        payloads.append(pay)
        prefixes.append(prev_tail.copy())
        de = np.concatenate(
            [pay[b * 64 * spec.cols:(b + 1) * 64 * spec.cols][didx]
             for b in range(spec.blocks_per_frame)])
        prev_tail = de[-62:]
    out = batch_decode_p_frames(jnp.asarray(np.stack(payloads)),
                                jnp.asarray(np.stack(prefixes)), rate=rate)
    info = np.asarray(out["info_bits"])
    su_ok = np.asarray(out["su_ok"])
    assert su_ok.all()
    recovered = sum(bits_to_bytes_lsb(info[j]) in fields
                    for j in range(len(payloads)))
    assert recovered == len(fields)


def test_batch_decode_600_frames_pass_crc():
    rng = np.random.default_rng(2)
    rate = 600
    spec = FRAME_SPECS[rate]
    fields = [b"".join(append_crc16_bytes(bytes([0x71] + list(rng.integers(0, 256, 9))))
                       for _ in range(6)) for _ in range(2)]
    bits = build_p_frames(fields, rate, lead_frames=1)
    soft = bits.astype(np.float32) * 255
    tb, hb = spec.total_bits, spec.header_bits
    payloads = np.stack([soft[j * tb + hb: j * tb + hb + spec.payload_soft_bits]
                         for j in range(len(bits) // tb)])
    prefixes = np.full((len(payloads), 62), 128.0, np.float32)
    a = batch_decode_p_frames(jnp.asarray(payloads), jnp.asarray(prefixes),
                              rate=rate)
    assert np.asarray(a["su_ok"])[1:-1].all()


def test_bank_matches_sequential():
    """BatchPChannelFramerBank (defer + one batched device decode) must
    produce the SAME events as per-VFO sequential PChannelFramers on the
    same soft streams — infofield, su_ok, frameinfo, frame_index, DCD."""
    from aero_tpu.protocol.batch_framing import BatchPChannelFramerBank
    from aero_tpu.protocol.framing import PChannelFramer

    rng = np.random.default_rng(7)
    rate = 1200
    streams = {}
    for v in range(3):
        fields = [b"".join(append_crc16_bytes(
            bytes([0x71] + list(rng.integers(0, 256, 9))))
            for _ in range(6)) for _ in range(3)]
        bits = build_p_frames(fields, rate, lead_frames=1 + v)
        soft = np.clip(bits.astype(np.float32) * 255
                       + rng.normal(0, 20, len(bits)), 0, 255)
        # one stream globally inverted: the polarity-invariant UW path
        if v == 1:
            soft = 255.0 - soft
        streams[f"V{v}"] = np.concatenate(
            [rng.integers(0, 256, 333).astype(np.float32), soft])

    bank = BatchPChannelFramerBank(rate, list(streams))
    seq = {t: PChannelFramer(rate) for t in streams}

    got_bank = {t: [] for t in streams}
    got_seq = {t: [] for t in streams}
    for i in range(0, max(len(s) for s in streams.values()), 777):
        chunk = {t: s[i:i + 777] for t, s in streams.items()}
        for t, evs in bank.feed(chunk).items():
            got_bank[t].extend(evs)
        for t, c in chunk.items():
            got_seq[t].extend(seq[t].feed(c))

    for t in streams:
        assert len(got_bank[t]) == len(got_seq[t]) > 0, t
        for a, b in zip(got_bank[t], got_seq[t]):
            assert a.infofield == b.infofield, t
            assert list(a.su_crc_ok) == list(b.su_crc_ok), t
            assert a.frameinfo == b.frameinfo and a.uw_errors == b.uw_errors
            assert a.frame_index == b.frame_index
        assert bank.framers[t].dcd == seq[t].dcd
        assert bank.framers[t].dcd_count == seq[t].dcd_count


def test_fused_station_batch_host_framing():
    """FusedStation(batch_host_framing=True) decodes the same ACARS as
    the per-VFO framing path."""
    from scipy.signal import firwin, lfilter
    from aero_tpu.channelizer import load_ini
    from aero_tpu.runtime.fused_station import FusedStation
    from aero_tpu.models.msk import msk_modulate
    from aero_tpu.protocol.isu import make_acars_userdata, segment_isu

    FS, CENTER = 288000, 1545000000
    rng = np.random.default_rng(5)
    ini = (f"[General]\nsample_rate={FS}\ncenter_frequency={CENTER}\n"
           "[vfos]\nsize=2\n"
           f"1\\frequency={CENTER + 24000}\n1\\data_rate=1200\n1\\topic=X\n"
           f"2\\frequency={CENTER - 24000}\n2\\data_rate=1200\n2\\topic=Y\n")
    cfg = load_ini(ini, is_text=True)

    def p_stream(tag, delta, dur):
        ud = make_acars_userdata("2", "N" + tag, "!", "H1", "A",
                                 f"BATCH {tag}")
        sus = [append_crc16_bytes(b)
               for b in segment_isu(ud, 0x345678, 0x41)]
        fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
        while len(sus) % 6:
            sus.append(fill)
        fields = [b"".join(sus[i:i + 6]) for i in range(0, len(sus), 6)]
        audio = msk_modulate(build_p_frames(fields, 1200, lead_frames=3),
                             24000, 1200.0, freq=1000.0)
        up = FS // 24000
        x = np.zeros(len(audio) * up, np.float32)
        x[::up] = audio * up
        bb = lfilter(firwin(511, 1.0 / up), 1.0, x).astype(np.complex64)
        t = np.arange(len(bb)) / FS
        w = (bb * np.exp(2j * np.pi * delta * t)).astype(np.complex64)
        return np.concatenate([w, np.zeros(dur - len(w), np.complex64)])

    dur = 8 * FS
    wb = p_stream("XX", 24000, dur) + p_stream("YY", -24000, dur)
    wb += (rng.normal(0, 0.003, dur)
           + 1j * rng.normal(0, 0.003, dur)).astype(np.complex64)

    results = {}
    for batch in (False, True):
        got = []
        st = FusedStation(cfg, ingest_dtype="int16", hunt=False,
                          batch_host_framing=batch,
                          on_acars=lambda v, item: got.append(
                              (v, item.message)))
        w = np.concatenate([wb, np.zeros(2 * st.block_len, np.complex64)])
        for i in range(0, (len(w) // st.block_len) * st.block_len,
                       st.block_len):
            st.process(w[i:i + st.block_len])
        st.flush()
        results[batch] = (sorted(set(got)), st.stats.frames,
                          st.stats.su_ok, st.stats.su_bad)

    assert ("X", "BATCH XX") in results[True][0]
    assert ("Y", "BATCH YY") in results[True][0]
    assert results[True] == results[False]


def test_deferred_relock_does_not_kill_new_sync():
    """Edge guard: when a deferred frame's bad UW triggers a prepare-time
    relock AND a new sync is acquired in the same feed, the stale frame's
    _finish_frame bookkeeping must not unlock the NEW sync (lock
    generation counter in PChannelFramer)."""
    from aero_tpu.protocol.batch_framing import BatchPChannelFramerBank

    rng = np.random.default_rng(3)
    rate = 1200
    spec = FRAME_SPECS[rate]
    # sA: two all-zero-payload frames; corrupt the SECOND frame's trailing
    # UW so the frame consumed after lock scores a bad UW at dcd=0
    sA = build_p_frames([], rate, lead_frames=1).astype(np.float32) * 255
    uw_start = 2 * spec.total_bits - spec.uw_bits
    sA[uw_start:] = rng.integers(0, 256, spec.uw_bits)
    # sB: a fresh sync followed by a good frame
    good = b"".join(append_crc16_bytes(
        bytes([0x71] + list(rng.integers(0, 256, 9)))) for _ in range(6))
    sB = build_p_frames([good], rate, lead_frames=2
                        ).astype(np.float32) * 255

    bank = BatchPChannelFramerBank(rate, ["V"])
    evs = bank.feed({"V": np.concatenate([sA, sB])})["V"]
    f = bank.framers["V"]
    assert f.locked, "stale deferred relock killed the new sync"
    assert any(bytes(e.infofield) == good for e in evs)


def test_bank_fuzz_equivalence_with_dropouts():
    """Property fuzz: over noisy streams with mid-stream signal dropouts
    and random chunk sizes, the bank and the sequential framers must
    recover the SAME set of CRC-valid infofields.  (Full event equality
    is guaranteed only in the steady state — junk frames at lock loss may
    differ by the documented one-frame relock skew — but no VALID frame
    may ever differ.)"""
    from aero_tpu.protocol.batch_framing import BatchPChannelFramerBank
    from aero_tpu.protocol.framing import PChannelFramer

    rate = 600
    for seed in range(4):
        rng = np.random.default_rng(100 + seed)
        fields = [b"".join(append_crc16_bytes(
            bytes([0x71] + list(rng.integers(0, 256, 9))))
            for _ in range(6)) for _ in range(3)]
        bits = build_p_frames(fields, rate, lead_frames=2)
        soft = np.clip(bits.astype(np.float32) * 255
                       + rng.normal(0, 45, len(bits)), 0, 255)
        # dropout: a noise gap mid-stream, then the signal resumes
        gap = rng.integers(900, 2400)
        cut = rng.integers(len(soft) // 3, len(soft) // 2)
        soft = np.concatenate([
            soft[:cut], rng.integers(0, 256, gap).astype(np.float32),
            build_p_frames(fields[:1], rate, lead_frames=2
                           ).astype(np.float32) * 255])

        bank = BatchPChannelFramerBank(rate, ["F"])
        seq = PChannelFramer(rate)
        got_b, got_s = [], []
        i = 0
        while i < len(soft):
            n = int(rng.integers(200, 1500))
            chunk = soft[i:i + n]
            i += n
            got_b += bank.feed({"F": chunk})["F"]
            got_s += seq.feed(chunk)

        def valid(evs):
            return sorted(bytes(e.infofield) for e in evs
                          if all(e.su_crc_ok))
        assert valid(got_b) == valid(got_s), f"seed {seed}"
        assert len(valid(got_s)) > 0, f"seed {seed}: nothing decoded"


@pytest.mark.parametrize("seed", [18, 23])
def test_bank_rewind_on_deferred_lock_loss(seed):
    """Regression for the rewind-on-relock fix: these seeds previously
    made the bank consume one junk frame past a lock loss, re-syncing a
    frame late and LOSING one good frame of the resumed signal (50-seed
    fuzz, 2026-08-21).  Bank and sequential must recover identical valid
    frame sets."""
    from aero_tpu.protocol.batch_framing import BatchPChannelFramerBank
    from aero_tpu.protocol.framing import PChannelFramer

    rate = 600
    rng = np.random.default_rng(1000 + seed)
    fields = [b"".join(append_crc16_bytes(
        bytes([0x71] + list(rng.integers(0, 256, 9))))
        for _ in range(6)) for _ in range(3)]
    bits = build_p_frames(fields, rate, lead_frames=2)
    soft = np.clip(bits.astype(np.float32) * 255
                   + rng.normal(0, 55, len(bits)), 0, 255)
    gap = rng.integers(600, 3000)
    cut = rng.integers(len(soft) // 4, 3 * len(soft) // 4)
    soft = np.concatenate([
        soft[:cut], rng.integers(0, 256, gap).astype(np.float32),
        build_p_frames(fields[:1], rate, lead_frames=2
                       ).astype(np.float32) * 255])

    bank = BatchPChannelFramerBank(rate, ["F"])
    seq = PChannelFramer(rate)
    gb, gs = [], []
    i = 0
    while i < len(soft):
        n = int(rng.integers(150, 2000))
        chunk = soft[i:i + n]
        i += n
        gb += bank.feed({"F": chunk})["F"]
        gs += seq.feed(chunk)

    def valid(evs):
        return sorted(bytes(e.infofield) for e in evs
                      if all(e.su_crc_ok))
    assert valid(gb) == valid(gs)
    assert len(valid(gs)) > 0


@pytest.mark.parametrize("seed", [2001, 2002, 2003])
def test_bank_equivalence_10500_arm_flips(seed):
    """Bank vs sequential at 10500 (arm-duplicated UW): global inversion
    (seed 2001) and single-arm flip (seed 2002) streams with a dropout
    must recover identical valid frame sets (24-seed fuzz, 2026-08-21)."""
    from aero_tpu.protocol.batch_framing import BatchPChannelFramerBank
    from aero_tpu.protocol.framing import PChannelFramer

    rate = 10500
    per = FRAME_SPECS[rate].payload_info_bits // 96
    rng = np.random.default_rng(seed)
    fields = [b"".join(append_crc16_bytes(
        bytes([0x71] + list(rng.integers(0, 256, 9))))
        for _ in range(per)) for _ in range(2)]
    bits = build_p_frames(fields, rate, lead_frames=1)
    soft = np.clip(bits.astype(np.float32) * 255
                   + rng.normal(0, 50, len(bits)), 0, 255)
    if seed % 3 == 1:
        soft = 255.0 - soft
    elif seed % 3 == 2:
        flip = (np.arange(len(soft)) % 2 == 0)
        soft = np.where(flip, 255.0 - soft, soft)
    gap = rng.integers(800, 2500)
    cut = rng.integers(len(soft) // 3, 2 * len(soft) // 3)
    soft = np.concatenate([
        soft[:cut], rng.integers(0, 256, gap).astype(np.float32),
        build_p_frames(fields[:1], rate, lead_frames=1
                       ).astype(np.float32) * 255])

    bank = BatchPChannelFramerBank(rate, ["F"])
    seq = PChannelFramer(rate)
    gb, gs = [], []
    i = 0
    while i < len(soft):
        n = int(rng.integers(900, 7000))
        chunk = soft[i:i + n]
        i += n
        gb += bank.feed({"F": chunk})["F"]
        gs += seq.feed(chunk)

    def valid(evs):
        return sorted(bytes(e.infofield) for e in evs
                      if all(e.su_crc_ok))
    assert valid(gb) == valid(gs)
