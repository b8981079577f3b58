"""The fused PBS path: the hand-written kernels wired into one hot path.

This is what `TaurusEngine(kernel_backend="fused")` runs: the batched
KS-first PBS (paper Fig. 3, steps A-D) with the paper's key reuse made
explicit as RESIDENT operands.

    keyswitch     `kernels.keyswitch` — the 64-bit MAC over the int8 gadget
                  digits of the whole batch as one int8 tensor-core GEMM
                  against the KSK's byte limbs, bit-identical to
                  `core.lwe.keyswitch`.
    blind rotate  per step, three launches: the forward FFT kernel takes
                  the rotate, subtract and decompose of the CMux
                  difference; one MAC kernel against the resident BSK
                  slice; the inverse FFT kernel rounds back onto the
                  torus and adds the accumulator.
    extract       `core.glwe.sample_extract`.

`FusedPbsPack` is the residency contract: the Fourier BSK is laid out in
the MAC kernel's re/im plane layout ONCE per key (`FusedPbsPack.shared`
keeps one pack per key's `bsk_f` tensor, so every engine, session and
backend of one context reads the same 2.6 GB at gpt2), and the KSK in the
keyswitch kernel's limb operand (`keyswitch.ksk_limbs`: its bytes,
K-major, (8T, S16) uint8, as much memory again as the int64 key, which
the reference engine keeps), and every later round reads the same
device tensors.  The pack is f64 only (an f32 transform voids
decryption on the 64-bit torus), and the TPU's tiling knobs (`block_f`,
`block_s`, `interpret`) have no counterpart here.

On a card the pack replays the PBS after its keyswitch (mod switch,
blind rotation, sample extract: `pbs_small_fused`, 3n launches) as one
captured CUDA graph, so a round costs the host one graph launch, not 3n
Python launches (`FusedPbsPack.pbs_from_small`).  A graph is kept per
(rows, device, current stream): the first call at a key runs eagerly,
the second captures and replays, later ones replay; `GRAPHS_PER_PACK`
graphs at most, the least recently used evicted.  A replay runs the
same kernels on the same operands, so its output is bit-identical to
the eager launches'.  The keyswitch stays one eager launch, and CPU
tensors take the plain path, never captured.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core import batch as batch_mod, decompose as dec, glwe, lwe
from repro_torch.core.params import TFHEParams
from repro_torch.kernels import _build, external_product, fourstep_fft, keyswitch


def bsk_to_planes(bsk_f: torch.Tensor) -> torch.Tensor:
    """Fourier BSK (n, k+1, level, k+1, M) complex -> kernel plane layout
    (n, 2, J, K, M) f64 with J = (k+1)*level rows, j = u*level + l, the
    order `external_product_planes` decomposes into."""
    n, kp1, level, _, M = bsk_f.shape
    flat = bsk_f.reshape(n, kp1 * level, kp1, M)
    return torch.stack([flat.real, flat.imag], dim=1).contiguous()


def keyswitch_fused(big_cts: torch.Tensor, ksk_limbs: torch.Tensor,
                    params: TFHEParams) -> torch.Tensor:
    """(B, big_n+1) -> (B, n+1) through the MAC kernel; `ksk_limbs` is
    the (S, n+1) int64 key with S = big_n * ks_level as the limb operand
    of `keyswitch.ksk_limbs`.  Bit-identical to `lwe.keyswitch`."""
    if params.ks_base_log > 8:
        raise ValueError(f"keyswitch_fused: ks_base_log {params.ks_base_log} > 8, "
                         "the digits do not fit int8")
    digits = dec.decompose(big_cts[:, :-1], params.ks_base_log, params.ks_level)
    digits = digits.reshape(big_cts.shape[0], -1).to(torch.int8)
    out = -keyswitch.keyswitch_mac(digits, ksk_limbs)
    out[:, -1] += big_cts[:, -1]
    return out


def external_product_planes(bsk_i: torch.Tensor, glwe_cts: torch.Tensor,
                            params: TFHEParams) -> torch.Tensor:
    """One resident BSK slice (2, J, K, M) applied to a GLWE batch
    (B, K, N): the digits' forward transforms, the MAC, the inverse
    transform back onto the torus (three launches)."""
    dig = fourstep_fft.fft_forward_digits(glwe_cts, None, params.pbs_base_log,
                                          params.pbs_level)
    out = external_product.external_product_mac(dig, bsk_i)      # (B, 2, K, M)
    return fourstep_fft.fft_inverse_torus(out, None)


def blind_rotate_fused(lut_glwes: torch.Tensor, ms_cts: torch.Tensor,
                       bsk_planes: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Batched blind rotation over the RESIDENT plane-layout BSK.

    lut_glwes (B, k+1, N); ms_cts (B, n+1) mod-switched to [0, 2N);
    bsk_planes (n, 2, J, K, M) — walked once, shared by the whole batch.
    Each CMux step is three launches: the digits of X^a_i * acc - acc
    through the forward transform, the MAC, and the inverse transform
    rounded onto the torus and added to acc.
    """
    N = params.N
    a, b = ms_cts[:, :-1], ms_cts[:, -1]
    acc = batch_mod.rotate_batch(lut_glwes, (2 * N - b) % (2 * N), N)
    for a_i, bsk_i in zip(a.T.contiguous(), bsk_planes):
        dig = fourstep_fft.fft_forward_digits(acc, a_i, params.pbs_base_log,
                                              params.pbs_level)
        out = external_product.external_product_mac(dig, bsk_i)
        acc = fourstep_fft.fft_inverse_torus(out, acc)
    return acc


def pbs_small_fused(small_cts: torch.Tensor, lut_polys: torch.Tensor,
                    bsk_planes: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """PBS minus the keyswitch: (B, n+1) small-key cts + (B, N) LUT polys
    -> (B, k*N+1)."""
    ms = lwe.mod_switch(small_cts, params.log2_N + 1)
    acc = blind_rotate_fused(glwe.trivial(lut_polys, params.k), ms,
                             bsk_planes, params)
    return glwe.sample_extract(acc)


def pbs_batch_fused(big_cts: torch.Tensor, lut_polys: torch.Tensor,
                    bsk_planes: torch.Tensor, ksk_limbs: torch.Tensor,
                    params: TFHEParams) -> torch.Tensor:
    """(B, k*N+1) + (B, N) LUT polys -> (B, k*N+1), all four PBS stages
    on the kernels with resident key operands."""
    return pbs_small_fused(keyswitch_fused(big_cts, ksk_limbs, params), lut_polys,
                           bsk_planes, params)


# a context's bsk_f tensor -> the resident pack of its key, dropped with
# the tensor (WeakIdKeyDictionary, since a tensor's == is elementwise)
_PACKS = WeakIdKeyDictionary()
_PACKS_LOCK = threading.Lock()

# Captured graphs a pack keeps.  Rounds are padded to 16, 32 or a
# multiple of 32 rows; a served steady state dispatches one or two such
# counts (288 and 320 rows in perfbench's `uint8-saturated`) and a radix
# program's rounds a few more.  A graph reserves its static inputs and
# the rotation's step tensors in a memory pool of its own: at 288 rows
# 65 MB at N 2048 and 1.0 GB at gpt2's N 32768 (measured on an H100), so
# 8 hold at most about 8 GB beside gpt2's 2.6 GB of BSK planes on 80 GB.
GRAPHS_PER_PACK = 8
SEEN_PER_PACK = 64      # keys seen once, remembered for their second call


class GraphCache:
    """A pack's captured graphs by key, the least recently used evicted
    past `size`; the keys seen once (at most `seen`); how many blind
    rotations ran each way (`counts`), and how this thread's last one ran
    (`local.how`)."""

    def __init__(self, size: int = GRAPHS_PER_PACK, seen: int = SEEN_PER_PACK):
        self.size, self.seen_size = size, seen
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.seen: collections.OrderedDict = collections.OrderedDict()
        self.capturing: set = set()
        self.counts = dict.fromkeys(("eager", "capture", "replay"), 0)
        self.local = threading.local()
        self.lock = threading.Lock()

    def lookup(self, key, capture):
        """(graph, how): the graph at `key` and "replay"; at a key seen
        once before, `capture()`'s graph, now cached, and "capture"; else
        (None, "eager"), and the key is remembered.  A capture runs
        outside the lock, so other keys replay meanwhile; a call at a key
        another thread is capturing runs eagerly, so a key is captured
        once."""
        with self.lock:
            graph = self.graphs.get(key)
            if graph is not None:
                self.graphs.move_to_end(key)
                how = "replay"
            elif self.seen.pop(key, False):
                self.capturing.add(key)
                how = "capture"
            else:
                if key not in self.capturing:
                    self.seen[key] = True
                    if len(self.seen) > self.seen_size:
                        self.seen.popitem(last=False)
                how = "eager"
            if how != "capture":
                self.counts[how] += 1
        if how == "capture":
            try:
                graph = capture()
            except BaseException:
                with self.lock:
                    self.capturing.discard(key)
                raise
            with self.lock:
                self.capturing.discard(key)
                self.graphs[key] = graph
                if len(self.graphs) > self.size:
                    self.graphs.popitem(last=False)
                self.counts[how] += 1
        self.local.how = how
        return graph, how


class _CapturedRotation:
    """`pbs_small_fused` at one (rows, device, stream), captured as a CUDA
    graph: static input buffers, the graph, its output in the graph's
    memory pool, and the tally of the launches it holds.  The loop's
    per-step tensors come from that pool too, freed blocks reused from
    step to step as in eager launches.

    Captured on a side stream (a capture cannot run on the legacy default
    stream) in thread-local mode, so other threads keep launching work
    and copying to the host meanwhile.  `__call__` holds the graph's lock
    from the copy-in to the enqueue of the copy-out, on the caller's
    stream, and returns a fresh tensor: no caller holds memory a later
    replay overwrites."""

    def __init__(self, pack: "FusedPbsPack", small_cts: torch.Tensor,
                 lut_polys: torch.Tensor):
        dev = small_cts.device
        self.small = torch.empty(small_cts.shape, dtype=small_cts.dtype, device=dev)
        self.luts = torch.empty(lut_polys.shape, dtype=lut_polys.dtype, device=dev)
        self.lock = threading.Lock()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(torch.cuda.Stream(dev)), _build.capturing() as launches:
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.out = pbs_small_fused(self.small, self.luts, pack.bsk_planes,
                                           pack.params)
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    self.graph.capture_end()
                raise
            self.graph.capture_end()
        self.launches = launches

    def __call__(self, small_cts: torch.Tensor, lut_polys: torch.Tensor) -> torch.Tensor:
        with self.lock:
            self.small.copy_(small_cts)
            self.luts.copy_(lut_polys)
            self.graph.replay()
            out = self.out.clone()
        _build.replayed(self.launches)
        return out


@dataclasses.dataclass
class FusedPbsPack:
    """Resident kernel operands for one evaluation-key pair, built once
    per key (`shared`) and read by every later round."""
    params: TFHEParams
    bsk_planes: torch.Tensor         # (n, 2, J, K, M) f64 planes
    ksk_limbs: torch.Tensor          # (8T, S16) uint8, S = big_n * ks_level
    _graphs: GraphCache = dataclasses.field(
        default_factory=GraphCache, init=False, repr=False, compare=False)

    @classmethod
    def build(cls, bsk_f: torch.Tensor, ksk: torch.Tensor,
              params: TFHEParams) -> "FusedPbsPack":
        n_from, level, t = ksk.shape
        return cls(params, bsk_to_planes(bsk_f),
                   keyswitch.ksk_limbs(ksk.reshape(n_from * level, t)))

    @classmethod
    def shared(cls, bsk_f: torch.Tensor, ksk: torch.Tensor,
               params: TFHEParams) -> "FusedPbsPack":
        """The one pack of the key whose Fourier BSK is `bsk_f` (an
        engine is built from one context's bsk_f, ksk and params), built
        on the first call and returned by every later one while bsk_f
        lives."""
        with _PACKS_LOCK:
            pack = _PACKS.get(bsk_f)
            if pack is None:
                pack = _PACKS[bsk_f] = cls.build(bsk_f, ksk, params)
            return pack

    # -- the engine entry points -------------------------------------------
    def pbs_batch(self, big_cts: torch.Tensor, lut_polys: torch.Tensor) -> torch.Tensor:
        """`pbs_batch_fused`: the keyswitch, then `pbs_from_small`."""
        return self.pbs_from_small(self.keyswitch(big_cts), lut_polys)

    def keyswitch(self, big_cts: torch.Tensor) -> torch.Tensor:
        return keyswitch_fused(big_cts, self.ksk_limbs, self.params)

    def blind_rotate(self, lut_glwes: torch.Tensor, ms_cts: torch.Tensor) -> torch.Tensor:
        return blind_rotate_fused(lut_glwes, ms_cts, self.bsk_planes, self.params)

    def pbs_from_small(self, small_cts: torch.Tensor, lut_polys: torch.Tensor) -> torch.Tensor:
        """The PBS resumed after `keyswitch` (the KS-level-dedup
        half-round too): `pbs_small_fused` on this pack's BSK.  On a card
        it runs eagerly at the first call of its (rows, device, current
        stream), captures the graph and replays it at the second, replays
        it after; `last_rotation()` says which."""
        dev = small_cts.device
        if dev.type != "cuda":
            self._graphs.local.how = None
            return pbs_small_fused(small_cts, lut_polys, self.bsk_planes, self.params)
        key = (int(small_cts.shape[0]), dev.index,
               torch.cuda.current_stream(dev).cuda_stream)
        graph, _ = self._graphs.lookup(
            key, lambda: _CapturedRotation(self, small_cts, lut_polys))
        if graph is None:
            return pbs_small_fused(small_cts, lut_polys, self.bsk_planes, self.params)
        return graph(small_cts, lut_polys)

    def last_rotation(self) -> str | None:
        """How this thread's last `pbs_from_small` ran: "eager",
        "capture" or "replay"; None on CPU tensors or before any."""
        return getattr(self._graphs.local, "how", None)

    def rotations(self) -> dict:
        """Blind rotations run so far by how: {"eager", "capture", "replay"}."""
        with self._graphs.lock:
            return dict(self._graphs.counts)

    # -- bandwidth accounting -------------------------------------------------
    @property
    def resident_key_bytes(self) -> tuple[int, int]:
        """(bsk_bytes, ksk_bytes) of the resident operands — what one
        fused round streams from device memory once, regardless of B
        (the KSK as its limb operand)."""
        return (self.bsk_planes.numel() * self.bsk_planes.element_size(),
                self.ksk_limbs.numel() * self.ksk_limbs.element_size())

    def bytes_streamed_per_round(self, batch: int) -> int:
        """Key-reuse traffic model of ONE fused round: the resident keys
        once, plus per-ciphertext input/LUT/output rows."""
        p = self.params
        bsk, ksk = self.resident_key_bytes
        per_ct = (2 * (p.big_n + 1) + p.N) * 8   # ct in + ct out + LUT poly
        return bsk + ksk + batch * per_ct
