"""aero-tpu: a JAX Inmarsat Aero receive framework.

Built from scratch in JAX/XLA with the capabilities of
airframesio/aero-cli (SDRReceiver/JAERO lineage): wideband IQ channelization,
MSK/OQPSK demodulation (continuous + burst), Aero-L protocol decode
(Viterbi / deinterleave / descramble / CRC), ISU/ACARS reassembly and
JSON/text output with TCP/UDP forwarding.

Architecture (nothing shared with the reference's per-sample C++/Qt design):

- ``aero_tpu.ops``         pure-JAX DSP primitives (NCO ramps, FIR/halfband via
                           convolution, RRC design, FFT helpers, AGC) designed
                           for dense block processing on the device.
- ``aero_tpu.channelizer`` the aero-publish half: batched VFO channelizer
                           (mix + halfband decimation cascade, USB demod).
- ``aero_tpu.models``      the "model zoo": MSK / OQPSK continuous and burst
                           demodulators as block-synchronous feedforward
                           estimators with symbol-rate scan loops, plus
                           matching modulators for synthetic test vectors.
- ``aero_tpu.protocol``    Aero-L codecs: CRC-16, LFSR scrambler, 64xN
                           interleaver, batched soft-decision Viterbi, and the
                           P/R/T/C-channel framing state machines.
- ``aero_tpu.parallel``    jax.sharding meshes; VFO-axis sharding across
                           devices and hosts.
- ``aero_tpu.io``          wire-compatible ZMQ transport, SDRReceiver INI
                           config, output formats (jsondump/jaero/text),
                           TCP/UDP forwarders, IQ file ingest.
- ``aero_tpu.runtime``     streaming executors that carry state pytrees
                           between jitted block steps; signal hunter.
"""

__version__ = "0.1.0"
