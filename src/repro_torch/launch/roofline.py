"""Roofline terms on the card: the port of `repro.launch.roofline`.

Hardware model: the card's data-sheet peaks (`PEAKS`, matched on the
name `nvidia-smi` reports; the H100 SXM by default):

    compute term    = FLOPs      / (chips * compute peak)
    memory term     = bytes      / (chips * memory rate)
    collective term = coll_bytes / (chips * NVLink rate)

The compute peak is the FP64 rate by default, because the PBS transforms
and the external-product MAC run in f64 (the keyswitch's int8
tensor-core work is not part of `pbs_flops`, as in the reference); the
LM stack's bf16 matmuls take `compute_peak="bf16_flops"`.

The reference builds a `Roofline` from compiled XLA HLO
(`from_compiled`, through `launch.hlo_analysis`).  PyTorch has no HLO to
read, so `from_counts` takes analytic FLOP and byte counts instead.
`model_flops(cfg, shape)` is the LM stack's useful-FLOP count.

`PbsRoundModel` / `pbs_round_model` are the reference's per-round
key-reuse traffic model, byte for byte; only `t_memory` reads the card's
memory rate.  `pbs_kernel_bytes` adds what that model leaves out: the
bytes each hand-written kernel moves per launch, counted as the card
bounds in `chip_smoke.py` count them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple


class Peaks(NamedTuple):
    mem_bw: float        # device memory, bytes/s
    fp64_flops: float    # FP64 tensor-core FLOP/s
    int8_ops: float      # int8 tensor-core OP/s
    bf16_flops: float    # bf16 tensor-core FLOP/s


# Data-sheet peaks by card (NVIDIA H100 data sheet, dense), matched on the
# name nvidia-smi reports; the first key contained in the name wins.
PEAKS = {"H100 PCIe": Peaks(2.0e12, 51.2e12, 1513e12, 756e12),
         "H100 NVL": Peaks(3.9e12, 60e12, 1671e12, 835e12),
         "H100": Peaks(3.35e12, 67e12, 1979e12, 989e12)}
H100_SXM = PEAKS["H100"]
# NVLink 4 on the H100 SXM: 900 GB/s per card both ways, 450 GB/s each way
NVLINK_BW = 450e9


def card_peaks(name: str) -> Peaks:
    """The data-sheet peaks of the card `name` (as nvidia-smi or
    `torch.cuda.get_device_name` report it)."""
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"no data-sheet peaks for {name!r}")


@dataclasses.dataclass
class Roofline:
    flops: float               # per-device FLOPs
    hbm_bytes: float           # per-device bytes moved
    coll_bytes: float          # per-device collective bytes
    chips: int
    coll_breakdown: dict
    model_flops: float = 0.0   # useful FLOPs of the whole job
    hbm_bytes_major: float = 0.0  # bytes if intermediates stayed on chip
    peaks: Peaks = H100_SXM
    compute_peak: str = "fp64_flops"   # the `Peaks` field FLOPs run at

    @property
    def peak_flops(self) -> float:
        return getattr(self.peaks, self.compute_peak)

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.peaks.mem_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def t_memory_major(self) -> float:
        """Optimistic memory term: only the bytes that must cross device
        memory (`hbm_bytes_major`) count."""
        return self.hbm_bytes_major / self.peaks.mem_bw

    @property
    def t_bound_major(self) -> float:
        return max(self.t_compute, self.t_memory_major, self.t_collective)

    @property
    def mfu_bound_major(self) -> float:
        t_useful = self.model_flops / (self.chips * self.peak_flops)
        return t_useful / self.t_bound_major if self.t_bound_major else 0.0

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu_bound(self) -> float:
        """Upper bound on achievable MFU: useful-FLOPs time over the
        roofline-dominant time."""
        t_useful = self.model_flops / (self.chips * self.peak_flops)
        return t_useful / self.t_bound if self.t_bound else 0.0

    @property
    def flops_ratio(self) -> float:
        """model FLOPs / counted FLOPs — how much counted compute is
        useful."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_memory_major_s": self.t_memory_major,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck, "mfu_bound": self.mfu_bound,
            "mfu_bound_major": self.mfu_bound_major,
            "flops_ratio": self.flops_ratio,
            "coll_breakdown": self.coll_breakdown,
        }


def model_flops(cfg, shape) -> float:
    """6*N*D for training, 2*N*D for a forward pass/prefill, 2*N_active per
    decoded token (D = tokens processed)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    # decode: one token per sequence; attention reads the whole KV cache —
    # count the matmul FLOPs only (2*N_active per token)
    return 2.0 * n_active * shape.global_batch


def train_step_bytes(param_bytes: int, n_params: int, *, compress: bool = False) -> int:
    """Least device-memory bytes of one train step: the parameters read
    (forward) and written (update), their gradients written and read (in
    the parameters' dtype), the f32 AdamW moments `m` and `v` read and
    written, and with int8 compression the f32 error-feedback buffer read
    and written.  Activations are left out (they may stay on chip)."""
    state = 2 * 4 * n_params                # one f32 tensor per param, read + written
    return 2 * param_bytes + 2 * param_bytes + 2 * state + (state if compress else 0)


@dataclasses.dataclass
class PbsRoundModel:
    """Analytic per-round traffic model of one fused `lut_batch` round.

    `fused_bytes` is the paper's key-reuse traffic: the evaluation keys
    stream from device memory ONCE per round regardless of batch size,
    plus O(B) ciphertext/LUT rows.  `unfused_bytes` re-streams the keys
    per ciphertext (the Morphling-XPU baseline, `lut_batch_xpu`).
    `FusedPbsPack.bytes_streamed_per_round` must never exceed
    `fused_bytes`.
    """
    bsk_bytes: int
    ksk_bytes: int
    ct_in_bytes: int           # one (big_n+1) u64 row
    ct_out_bytes: int
    lut_bytes: int             # one (N,) u64 test polynomial
    batch: int
    peaks: Peaks = H100_SXM

    @property
    def key_bytes(self) -> int:
        return self.bsk_bytes + self.ksk_bytes

    @property
    def per_ct_bytes(self) -> int:
        return self.ct_in_bytes + self.ct_out_bytes + self.lut_bytes

    @property
    def fused_bytes(self) -> int:
        """Keys once + per-ciphertext rows (key-reuse residency)."""
        return self.key_bytes + self.batch * self.per_ct_bytes

    @property
    def unfused_bytes(self) -> int:
        """Keys re-streamed per ciphertext (no reuse baseline)."""
        return self.batch * (self.key_bytes + self.per_ct_bytes)

    @property
    def reuse_factor(self) -> float:
        return self.unfused_bytes / self.fused_bytes

    @property
    def t_memory(self) -> float:
        """Memory-bound wall clock of one fused round on the card."""
        return self.fused_bytes / self.peaks.mem_bw

    @property
    def arithmetic_intensity_keys(self) -> float:
        """MAC ops per key byte — scales with B under residency."""
        return float(self.batch) / max(self.key_bytes, 1)

    def to_dict(self) -> dict:
        return {
            "bsk_bytes": self.bsk_bytes, "ksk_bytes": self.ksk_bytes,
            "per_ct_bytes": self.per_ct_bytes, "batch": self.batch,
            "fused_bytes": self.fused_bytes,
            "unfused_bytes": self.unfused_bytes,
            "reuse_factor": self.reuse_factor,
            "t_memory_s": self.t_memory,
        }


def pbs_round_model(params, batch: int, peaks: Peaks = H100_SXM) -> PbsRoundModel:
    """Build the per-round bandwidth model from TFHE parameters.

    Key bytes match `TaurusEngine.key_bytes` exactly: the Fourier BSK is
    (n, k+1, level, k+1, N/2) complex128 and the KSK is
    (big_n, ks_level, n+1) int64; the fused pack's plane layout is the
    same bytes (2 x f64 = c128), and its KSK limb operand too wherever
    big_n * ks_level is a multiple of 16 (it pads S to one).
    """
    n, k, N = params.n, params.k, params.N
    bsk = n * (k + 1) * params.pbs_level * (k + 1) * (N // 2) * 16
    ksk = params.big_n * params.ks_level * (n + 1) * 8
    ct = (params.big_n + 1) * 8
    return PbsRoundModel(bsk_bytes=bsk, ksk_bytes=ksk, ct_in_bytes=ct,
                         ct_out_bytes=ct, lut_bytes=N * 8, batch=batch,
                         peaks=peaks)


def pbs_kernel_bytes(params, rows: int) -> dict:
    """Bytes one launch of each kernel moves in a fused round of `rows`
    ciphertexts, each input read once and each output written once (the
    count behind `chip_smoke.py`'s bounds): the keyswitch reads int8
    digits and the KSK limb operand and writes int64 sums; the forward
    FFT reads the accumulator and the shifts and writes f64 digit planes;
    the MAC reads those and one BSK slice and writes the product planes;
    the inverse FFT reads the product and the accumulator and writes the
    accumulator.  A round launches the keyswitch once and the others n
    times each."""
    K, M = params.k + 1, params.N // 2
    J = K * params.pbs_level
    S, T = params.big_n * params.ks_level, params.n + 1
    s16 = S + (-S) % 16
    acc = rows * K * params.N * 8
    dig = rows * 2 * J * M * 8
    out = rows * 2 * K * M * 8
    return {"keyswitch_mac": rows * S + 8 * T * s16 + rows * T * 8,
            "fft_forward_digits": acc + rows * 8 + dig,
            "external_product_mac": dig + 2 * J * K * M * 8 + out,
            "fft_inverse_torus": out + 2 * acc}


def from_counts(flops: float, hbm_bytes: float, chips: int = 1, *,
                coll_bytes: float = 0.0, coll_breakdown: dict | None = None,
                model_flops: float = 0.0, hbm_bytes_major: float = 0.0,
                peaks: Peaks = H100_SXM, compute_peak: str = "fp64_flops") -> Roofline:
    """A `Roofline` from analytic per-device counts (where the reference's
    `from_compiled` reads them from compiled HLO)."""
    return Roofline(flops=flops, hbm_bytes=hbm_bytes, coll_bytes=coll_bytes,
                    chips=chips, coll_breakdown=coll_breakdown or {},
                    model_flops=model_flops, hbm_bytes_major=hbm_bytes_major,
                    peaks=peaks, compute_peak=compute_peak)
