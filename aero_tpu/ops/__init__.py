"""Pure-JAX DSP primitives for block-synchronous streaming.

Every streaming op follows one convention:

    state = op_init(...)                      # pytree of carries
    state, y = op_apply(state, x_block, ...)  # jit/vmap/shard-friendly

Blocks are dense arrays shaped ``[..., T]`` (trailing time axis); the leading
axes are free for vmap/sharding over a VFO/channel axis. No per-sample Python
loops anywhere: sample-rate recurrences are either reformulated as
block-parallel estimators or expressed as ``lax.scan``.
"""

from aero_tpu.ops.nco import nco_init, nco_mix, nco_phase_ramp
from aero_tpu.ops.fir import (
    fir_init,
    fir_apply,
    fir_decimate_init,
    fir_decimate_apply,
    halfband_cascade_init,
    halfband_cascade_apply,
)
from aero_tpu.ops.design import (
    HALFBAND_TAPS,
    low_pass_design,
    root_raised_cosine,
    hilbert_design,
    msk_matched_filter,
)
from aero_tpu.ops.stats import block_agc, moving_average_init, moving_average_apply
from aero_tpu.ops.spectral import single_bin_dft, tone_phase_and_freq
