#!/usr/bin/env python3
"""Generate the synthetic parity fixture (tests/fixtures/).

Synthesizes a 1200 bps P-channel WAV carrying known ACARS messages, then
decodes it and writes the decoded jsondump lines as expected.jsonl —
after VERIFYING every transmitted message text came back, so the
committed fixture is anchored to TX truth.  Real captures drop in next
to it with expected.jsonl taken from aero-decode/JAERO instead
(ref /root/reference/README.md:33).

Usage: python tools/make_fixture.py [outdir] [rate] [--platform cpu]
"""

from __future__ import annotations

import os
import sys
import wave

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MESSAGES = [
    (0x4001AA, "VH-ABC", "H1", "PARITY FIXTURE MESSAGE ONE"),
    (0x4002BB, "N425SK", "AA", "MSG TWO: QUICK BROWN FOX 0123456789"),
    (0x4003CC, "C-FPAR", "B6", "THIRD AND FINAL PARITY MESSAGE"),
]


def make(outdir: str, name: str | None = None,
         rate: int = 1200) -> tuple[str, str]:
    from aero_tpu.models.msk import msk_modulate
    from aero_tpu.models.oqpsk import oqpsk_modulate
    from aero_tpu.protocol.framing import build_p_frames, FRAME_SPECS
    from aero_tpu.protocol.crc import append_crc16_bytes
    from aero_tpu.protocol.isu import make_acars_userdata, segment_isu
    from aero_tpu.io.output import to_output_format
    from aero_tpu.runtime.decoder import Decoder, DecoderOptions

    name = name or f"synthetic_{rate}"
    fs = {600: 12000, 1200: 24000}.get(rate, 48000)
    per = FRAME_SPECS[rate].payload_info_bits // 96      # SUs per infofield
    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    fields = []
    sus = []
    for aes, reg, label, text in MESSAGES:
        ud = make_acars_userdata("2", reg, "!", label, "A", text)
        sus += [append_crc16_bytes(b) for b in segment_isu(ud, aes, 0x41)]
    while len(sus) % per:
        sus.append(fill)
    fields = [b"".join(sus[i:i + per]) for i in range(0, len(sus), per)]
    bits = build_p_frames(fields, rate, lead_frames=3)
    if rate in (600, 1200):
        audio = msk_modulate(bits, fs, float(rate), freq=1000.0)
    else:
        audio = oqpsk_modulate(bits, fs, float(rate), freq=8000.0,
                               amplitude=0.4)
    rng = np.random.default_rng(0)
    audio = audio + rng.normal(0, 0.01, len(audio)).astype(np.float32)
    audio = np.concatenate([audio, np.zeros(2 * fs, np.float32)])

    os.makedirs(outdir, exist_ok=True)
    wav_path = os.path.join(outdir, f"{name}.wav")
    with wave.open(wav_path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2")
                      .tobytes())

    import contextlib
    import io as _io
    dec = Decoder(DecoderOptions(bitrate=rate, station_id="FIXTURE"))
    with contextlib.redirect_stdout(_io.StringIO()):
        dec.run_file(wav_path)
    texts = {item.message for item in dec.items}
    for _, _, _, text in MESSAGES:
        assert text in texts, f"TX message not recovered: {text!r}"

    exp_path = os.path.join(outdir, f"{name}.expected.jsonl")
    with open(exp_path, "w") as f:
        for item in dec.items:
            f.write(to_output_format("jsondump", "FIXTURE", False, item)
                    + "\n")
    return wav_path, exp_path


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outdir", nargs="?", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "fixtures"))
    ap.add_argument("rate", nargs="?", type=int, default=None)
    ap.add_argument("--platform", default="cpu",
                    help="JAX platform for the verifying decode")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", args.platform)
    for rate in [args.rate] if args.rate else [1200, 10500]:
        wav, exp = make(args.outdir, rate=rate)
        print(f"wrote {wav} and {exp}")
