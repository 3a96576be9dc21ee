"""Viterbi decoders (lax.scan batch decoder vs native C++) and native
component tests."""

import numpy as np
import jax.numpy as jnp
import pytest

from aero_tpu.protocol.viterbi import conv_encode, viterbi_decode_soft


def test_native_viterbi_matches_jax():
    from aero_tpu import native
    if not native.have_native():
        pytest.skip("no C++ toolchain")
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, size=500).astype(np.uint8)
    soft = np.clip((conv_encode(bits).astype(np.float32) * 2 - 1
                    + rng.normal(0, 0.6, 1000)) * 127 + 128, 0, 255)
    b_native = native.viterbi_decode_soft_native(soft)
    b_jax = np.asarray(viterbi_decode_soft(jnp.asarray(soft)))
    np.testing.assert_array_equal(b_native, b_jax)


def test_database_stub():
    from aero_tpu.protocol.database import DataBaseTextUser, DATABASE_SCHEMA
    results = []
    db = DataBaseTextUser(on_result=lambda ok, ref, res: results.append((ok, ref, res)))
    ref = db.request("", "ABCDEF", userdata={"x": 1})
    assert results == [(False, ref, [])]
    assert db.get_userdata(ref) == {"x": 1}
    assert "Registration" in DATABASE_SCHEMA


def _noisy_frames(rate, n, seed, sigma=0.6):
    """n frames' worth of coded soft bytes in coded-stream order (what the
    framers hand the batch decoder), plus the 62-soft-bit prefixes."""
    from aero_tpu.protocol.framing import FRAME_SPECS
    rng = np.random.default_rng(seed)
    spec = FRAME_SPECS[rate]
    info = rng.integers(0, 2, size=(n, spec.payload_info_bits + 31))
    coded = np.stack([conv_encode(b) for b in info.astype(np.uint8)])
    soft = np.clip((coded * 2.0 - 1 + rng.normal(0, sigma, coded.shape))
                   * 127 + 128, 0, 255).astype(np.float32)
    return soft[:, :62], soft[:, 62:62 + spec.payload_soft_bits]


@pytest.mark.parametrize("rate", [600, 1200, 10500])
def test_batch_decoder_bit_equal_to_native(rate):
    """The device batch decoder (vmapped lax.scan, protocol/batch_framing)
    and the native C++ host decoder make the same decisions on noisy
    frames of each P rate: same trellis, same tie-breaks."""
    from aero_tpu import native
    from aero_tpu.protocol.batch_framing import (HISTORY, LOOKAHEAD,
                                                 batch_decode_p_frames)
    from aero_tpu.protocol.framing import FRAME_SPECS
    from aero_tpu.protocol.scrambler import SCRAMBLE_KEYSTREAM
    if not native.have_native():
        pytest.skip("no C++ toolchain")
    n_info = FRAME_SPECS[rate].payload_info_bits
    prefixes, payloads = _noisy_frames(rate, 4, seed=rate)
    dev = np.asarray(batch_decode_p_frames(
        jnp.asarray(payloads), jnp.asarray(prefixes), rate=rate,
        pre_deinterleaved=True)["info_bits"])
    ks = SCRAMBLE_KEYSTREAM[:n_info]
    for i in range(len(payloads)):
        buf = np.concatenate([prefixes[i], payloads[i],
                              np.full(LOOKAHEAD, 128.0, np.float32)])
        bits = native.viterbi_decode_soft_native(buf)
        host = bits[HISTORY // 2: HISTORY // 2 + n_info] ^ ks
        np.testing.assert_array_equal(dev[i], host)


@pytest.mark.gpu
def test_batch_decoder_on_gpu_bit_equal_to_cpu(gpu_device):
    """The batch decoder compiled for the GPU makes the CPU's decisions."""
    import jax
    from aero_tpu.protocol.batch_framing import batch_decode_p_frames
    prefixes, payloads = _noisy_frames(1200, 32, seed=3)
    out = {}
    for dev in (gpu_device, jax.devices("cpu")[0]):
        with jax.default_device(dev):
            out[dev.platform] = np.asarray(batch_decode_p_frames(
                jnp.asarray(payloads), jnp.asarray(prefixes), rate=1200,
                pre_deinterleaved=True)["info_bits"])
    np.testing.assert_array_equal(out["gpu"], out["cpu"])
