"""Concurrent multi-stream serving: N live streams, shared dispatches,
device-resident audio.

The single-stream `DeviceStreamingPipeline` runs B=1 device programs, so
its rate is bound by the per-dispatch cost, not by compute.
`MultiStreamPipeline` amortizes that cost across N concurrent
feed()/flush() streams by multiplexing them into shared FIXED-SHAPE device
programs, and keeps each stream's recent raw audio RESIDENT ON DEVICE so
every audio sample crosses the host<->device link exactly once (a
host-upload design re-ships each sample ~5x — once for its analysis chunk
and ~4x more inside overlapping WSOLA segment windows).

  1. INGEST + ANALYSIS + SPEED LAW: one jitted ROUND program per upload
     bucket: scatter the new samples into a per-slot ring [N, R], then a
     masked lax.scan of up to NC analysis chunk steps per slot (the
     O(1)-state scan of ops/chunked.py::make_chunk_step) FUSED with the
     per-frame speed law — bit-identical math to the single-stream
     pipeline's separate dispatches (the law is ops/speed.py's exact
     scan; masked slots take identity steps). Only the speeds [N,NC,Ch]
     return to the host (~50 KB); tension is consumed on device.
  2. WSOLA: the grid engine dispatched once per round over all ready
     streams' segments, the [N, L_seg] source windows GATHERED FROM THE
     RING on device (the host-upload path ships ~11 MB per dispatch
     instead). The output ships trimmed to a rate-derived cap (the
     plan's worst-case capacity is ~min_speed/rate x larger than any
     real segment's output; a full-capacity fallback program serves the
     rare dispatch that exceeds the trim).

Wire format: float32 by default (bit-compatible with every existing
gate). `wire_dtype="int16"` switches BOTH directions to the reference's
native PCM serving format (sonicWriteShortToStream/sonicReadShortFromStream,
soniclib.c:496,516): feeds take int16 arrays converted on device by the
add_data_short rule x/2^15 (streaming.py:219), and outputs return as
int16 via the shim's float->short rule clip(round(x*2^15)) applied on
device (streaming.py:687-689) — halving wire bytes. The int16 gate pins
outputs to the single-stream pipeline with the same conversions applied
on the host.

Per-stream state (raw ring, output clock, phase re-base, pruning) is the
single-stream pipeline's own — each lane IS a `DeviceStreamingPipeline`
with only its three device-call seams re-routed through the coordinator,
so every contract the single-stream pipeline is gated on (seam exactness,
feed-chunking invariance, flush semantics, set_speed, multichannel) holds
per lane by construction. The host keeps its pruned `_raw` mirror as the
source of truth: any dispatch whose window has aged out of the device
ring falls back to the host-upload path (counted in stats), so
ring capacity is a performance knob, never a correctness bound.

All lanes share one segment plan (same cfg / chunk_frames /
segment_frames / speed bounds — the static shapes of the shared
programs); per-stream global_speed may differ within the plan's speed
bounds. Multichannel pipelines keep the host-upload path (the ring is
mono — the serving hot path). The reference's serving analog is one
sonicStream per caller (soniclib.c:427-450) — N callers pay N serial C
loops there; here they share one device program and one wire.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import config as C
from .config import SpeedyConfig
from .ops import wsola_fast
from .ops.chunked import make_chunk_step
from .ops.speed import speed_law_step
from .parallel.batch import _plan_max_speed
from .streaming_device import DeviceStreamingPipeline

# Device ints are int32: absolute sample positions must stay below 2^31
# (~37 h of 16 kHz audio per stream). Serving sessions re-open slots long
# before that; asserted loudly at dispatch time.
_ABS_LIMIT = 2**31 - 2**26


def _law_factory(nonlinear_factor: float, feedback: float):
    """The per-chunk speed-law scan (`ops.speed.speed_law_step` — the
    shared speedy.c:768-788 body) with identity steps on masked slots."""
    fd = 1.0 / C.FRAME_RATE_HZ
    ms = C.MIN_SPEED
    nl = float(nonlinear_factor)
    fb = float(feedback)

    def law(tension, rg, carry, slot_valid):
        def step(c, tv):
            t, v = tv
            cur, des = c
            cur2, des2, final = speed_law_step(cur, des, t, rg, fb, nl, ms, fd)
            return (
                jnp.where(v, cur2, cur),
                jnp.where(v, des2, des),
            ), final

        (cur, des), speeds = jax.lax.scan(
            step, (carry[0], carry[1]), (tension, slot_valid), unroll=16
        )
        return speeds, jnp.stack([cur, des])

    return law


@functools.lru_cache(maxsize=8)
def _batched_chunk_law_step(
    cfg: SpeedyConfig,
    chunk_frames: int,
    nonlinear_factor: float,
    feedback: float,
):
    """HOST-UPLOAD fused step (the multichannel / ring-fallback path):
    vmapped O(1)-state analysis chunk scan + masked speed-law scan.
    Signature (all leading dims = n_slots):

      (an_carry, law_carry[N,2], k[N], samples[N,Ch*step], rg[N],
       lo[N], hi[N], valid[N])
        -> (an_carry', law_carry', tension[N,Ch], speeds[N,Ch])

    Row semantics: valid=False rows pass their carries through untouched
    (the slot had no chunk ready this round). k==0 rows read the FRESH
    initial carry (slot reuse after a flush needs no reset dispatch —
    freshness is derivable from the chunk counter). Law slots outside
    [lo, hi) take identity steps, exactly reproducing the single-stream
    pipeline's trimming (`t[lo:]` for the lag slots, the flush-time
    T_out cap)."""
    carry0, body = make_chunk_step(cfg, chunk_frames)
    Ch = chunk_frames
    law = _law_factory(nonlinear_factor, feedback)

    def one(an_row, law_row, k, samples, rg, lo, hi, valid):
        use0 = k == 0
        an_in = jax.tree_util.tree_map(
            lambda a0, a: jnp.where(use0, a0, a), carry0, an_row
        )
        law_in = jnp.where(use0, jnp.zeros((2,), samples.dtype), law_row)
        an_new, tension = body(an_in, (k, samples))
        j = jnp.arange(Ch)
        slot_valid = valid & (j >= lo) & (j < hi)
        speeds, law_new = law(tension, rg, law_in, slot_valid)
        an_out = jax.tree_util.tree_map(
            lambda n, o: jnp.where(valid, n, o), an_new, an_row
        )
        law_out = jnp.where(valid, law_new, law_row)
        return an_out, law_out, tension, speeds

    def init_state(n_slots: int):
        an = jax.tree_util.tree_map(
            lambda a: jnp.tile(a[None], (n_slots,) + (1,) * a.ndim), carry0
        )
        law = jnp.zeros((n_slots, 2), jnp.float32)
        return an, law

    return jax.jit(jax.vmap(one)), init_state


# ---------- device ring primitives ----------
#
# The "ring" is a SLIDING WINDOW [R] holding absolute sample positions
# [written - R, written): no modulo arithmetic anywhere, so every op is
# a contiguous static-length lax.dynamic_slice (per-row large-slice
# gathers under vmap — one DMA per row). The first formulation used
# element-wise jnp.take with mod-R indices, which XLA lowers to
# scalar-granularity gathers.


def _ring_write(ring_row, new_row, n_new):
    """Slide the window past n_new new samples: the [R]-slice of
    concat(window, new) starting at n_new ends exactly at the last new
    sample (pad beyond n_new never enters the window)."""
    R = ring_row.shape[0]
    c = jnp.concatenate([ring_row, new_row])
    return jax.lax.dynamic_slice(c, (n_new.astype(jnp.int32),), (R,))


def _ring_read(ring_row, start, length, written, lo, hi):
    """[length] window at absolute positions start+i: the window value
    where lo <= pos < hi, else 0 (reproducing the host seg builder's
    zeroing below the retention base and past the fed watermark — the
    flush zero-extension region is >= fed, so masking covers it too).
    `written` is the window's absolute end. Reads that start past
    `written` clamp the slice offset; every clamped position is >= hi
    and masked to 0, so alignment never matters there."""
    R = ring_row.shape[0]
    ext = jnp.concatenate(
        [ring_row, jnp.zeros((length,), ring_row.dtype)]
    )
    off = jnp.clip(start - written + R, 0, R).astype(jnp.int32)
    v = jax.lax.dynamic_slice(ext, (off,), (length,))
    p = start + jnp.arange(length, dtype=jnp.int32)
    return jnp.where((p >= lo) & (p < hi), v, jnp.zeros((), ring_row.dtype))


@functools.lru_cache(maxsize=16)
def _ring_round_step(
    cfg: SpeedyConfig,
    chunk_frames: int,
    nonlinear_factor: float,
    feedback: float,
    R: int,
    U: int,
    NC: int,
    wire_i16: bool,
):
    """One compiled ROUND: ring write + masked scan of up to NC analysis
    chunk + law steps per slot. Signature (leading dims = n_slots):

      (ring[N,R], an_carry, law[N,2], new[N,U] (i16 or f32),
       n_new[N], hi[N] (ring-valid watermark = samples written after
       this round's write), k0[N], n_ch[N], rg[N], t_cap[N])
        -> (ring', an_carry', law', speeds[N,NC,Ch])

    Chunk c of row i runs iff c < n_ch[i]; its samples are
    ring[(k0+c)*Ch*step ...] masked to [0, hi) (zeros beyond the fed
    watermark — identical to the host's flush zero-extension). The law
    masks slots to global tension frames [0, t_cap) (t_cap = T_out at
    flush, else +inf), replacing the host lo/hi arithmetic. Tension
    never returns to the host (only its count matters there)."""
    carry0, body = make_chunk_step(cfg, chunk_frames)
    Ch = chunk_frames
    ChS = Ch * cfg.frame_step_int
    fut = cfg.hysteresis_future
    law = _law_factory(nonlinear_factor, feedback)

    def one(ring_row, an_row, law_row, new_row, n_new, hi, k0, n_ch, rg, t_cap):
        if wire_i16:
            new_f = new_row.astype(jnp.float32) / 32768.0  # add_data_short
        else:
            new_f = new_row
        ring2 = _ring_write(ring_row, new_f, n_new)

        def it(carry, c):
            an, lawc = carry
            k = k0 + c
            run = c < n_ch
            samples = _ring_read(ring2, k * ChS, ChS, hi, jnp.int32(0), hi)
            use0 = k == 0
            an_in = jax.tree_util.tree_map(
                lambda a0, a: jnp.where(use0, a0, a), carry0, an
            )
            law_in = jnp.where(use0, jnp.zeros((2,), jnp.float32), lawc)
            an2, tension = body(an_in, (k, samples))
            g = k * Ch - 2 - fut + jnp.arange(Ch)
            slot_valid = run & (g >= 0) & (g < t_cap)
            speeds, law2 = law(tension, rg, law_in, slot_valid)
            an_out = jax.tree_util.tree_map(
                lambda n2, o: jnp.where(run, n2, o), an2, an
            )
            law_out = jnp.where(run, law2, lawc)
            return (an_out, law_out), speeds

        (an_f, law_f), sp = jax.lax.scan(
            it, (an_row, law_row), jnp.arange(NC, dtype=jnp.int32)
        )
        return ring2, an_f, law_f, sp

    fn = jax.vmap(one)
    return jax.jit(fn, donate_argnums=(0, 1, 2))


@functools.lru_cache(maxsize=16)
def _ring_seg_step(
    cfg: SpeedyConfig,
    R: int,
    L_seg: int,
    F_in: int,
    K_st: int,
    capacity: int,
    out_cap: int,
    step: int,
    Hs: int,
    max_sb: float,
    wire_i16: bool,
):
    """One compiled WSOLA segment dispatch sourcing its [N, L_seg]
    windows from the device ring: (ring, s0[N], lo[N], hi[N], lens, sps,
    ino, osh, prf) -> (y[N, out_cap] (wire dtype), periods). lo/hi are
    the per-row zeroing bounds (retention base / fed watermark) the host
    seg builder applies (streaming_device.py:238-246)."""

    def fn(ring, s0, lo, hi, lens, sps, ino, osh, prf):
        # At segment time the pump has drained every pending write, so
        # the fed watermark (hi) IS the window's absolute end.
        segs = jax.vmap(
            lambda r, s, l, h: _ring_read(r, s, L_seg, h, l, h)
        )(ring, s0, lo, hi)
        res, periods = wsola_fast._wsola_grid_batch(
            segs,
            lens,
            sps,
            cfg.wsola_min_period,
            cfg.wsola_max_period,
            step,
            Hs,
            capacity,
            K_st,
            xs_channels=None,
            max_speed_plan=max_sb,
            in_offset=ino,
            out_shift=osh,
            phase_ref=prf,
            mask_output=False,
            return_period=True,
        )
        y = jax.lax.slice_in_dim(res.output, 0, out_cap, axis=-1)
        if wire_i16:
            # streaming.py read_short rule: clip(round(x * 2^15)).
            y = jnp.clip(jnp.round(y * 32768.0), -32768, 32767).astype(jnp.int16)
        return y, periods

    return jax.jit(fn)


class _Lane(DeviceStreamingPipeline):
    """One stream slot: a DeviceStreamingPipeline whose device calls are
    re-routed through the owning MultiStreamPipeline's shared batched
    programs. All host-side state machinery (rings, clocks, flush
    semantics) is inherited unchanged; the host `_raw` mirror stays the
    source of truth (ring-miss dispatches fall back to it)."""

    def __init__(self, owner: "MultiStreamPipeline", slot: int, **kw):
        self._owner = owner
        self._slot = slot
        self._pending_speeds: Optional[np.ndarray] = None
        self._flush_T_out: Optional[int] = None
        self._ring_fed = 0  # absolute samples written to the device ring
        self._wire_pending: List[np.ndarray] = []  # int16 wire payloads
        super().__init__(**kw)

    @property
    def _lazy_seg(self) -> bool:
        # Ring lanes skip materializing the host seg window per segment
        # (the device ring serves the dispatch); the ring-miss fallback
        # rebuilds it via _build_seg_window (streaming_device.py).
        # Property: lanes can be built before the owner creates its ring.
        return self._owner._ring is not None

    # The coordinator drives all pumping (a lane's feed may unblock work
    # on every lane that was waiting for a shared dispatch round).
    def _pump(self):
        self._owner._pump_all()

    def _ingest(self, samples: np.ndarray) -> None:
        if self._owner._wire_i16:
            s = np.asarray(samples)
            assert s.dtype == np.int16, (
                "wire_dtype='int16' pipelines take int16 PCM feeds "
                f"(got {s.dtype}; construct with wire_dtype='float32' "
                "for float feeds)"
            )
            if s.ndim == 2 and s.shape[1] == 1:
                s = s[:, 0]
            assert s.ndim == 1, "int16 wire feeds are 1-D mono PCM"
            if self._owner._ring is not None:
                # _wire_pending stages ring uploads; without a device
                # ring nothing consumes it (host-upload dispatches read
                # the float raw mirror), so don't retain PCM history.
                self._wire_pending.append(np.ascontiguousarray(s))
            samples = s.astype(np.float32) / 32768.0  # add_data_short
        super()._ingest(samples)

    def _ring_pending(self) -> int:
        return self._fed - self._ring_fed

    def _take_pending(self, cap: int) -> np.ndarray:
        """Up to `cap` not-yet-uploaded samples in wire dtype (int16
        payloads verbatim; float32 from the host raw mirror)."""
        n = min(self._ring_pending(), cap)
        if n <= 0:
            return np.zeros((0,), self._owner._wire_np)
        if self._owner._wire_i16:
            out = np.empty((n,), np.int16)
            got = 0
            while got < n:
                head = self._wire_pending[0]
                take = min(n - got, head.shape[0])
                out[got : got + take] = head[:take]
                got += take
                if take == head.shape[0]:
                    self._wire_pending.pop(0)
                else:
                    self._wire_pending[0] = head[take:]
            return out
        a = self._ring_fed - self._raw_base
        assert a >= 0, "host raw pruned past the ring watermark"
        return np.ascontiguousarray(
            self._mono(self._raw[a : a + n]).astype(np.float32)
        )

    # Single-lane analysis path (used by the inherited flush loop; the
    # live pump path batches across lanes in _pump_all instead).
    def _run_analysis_chunk(self, samples: np.ndarray) -> np.ndarray:
        if self._owner._ring is not None:
            (per_chunk,) = self._owner._dispatch_round([self], force_one=True)
            ((t, sp),) = per_chunk
        else:
            ((t, sp),) = self._owner._dispatch_chunks([(self, samples)])
        self._k += 1
        self._pending_speeds = sp
        return t

    def _extend_speeds(self, tension: np.ndarray) -> None:
        # The fused step already computed this chunk's speeds (stashed by
        # _run_analysis_chunk / _pump_all); only the host bookkeeping of
        # the base method remains. The device law carry lives stacked in
        # the owner.
        sp = self._pending_speeds
        self._pending_speeds = None
        if tension.size == 0:
            return
        assert sp is not None and sp.shape == tension.shape, (
            None if sp is None else sp.shape,
            tension.shape,
        )
        sp = np.clip(sp.astype(np.float64), self.min_sb, self.max_sb)
        for s in sp:
            self._speeds.append(float(s))
            self._obnd.append(self._obnd[-1] + self.step / float(s))
        self._t_emitted += tension.size

    def _wsola_dispatch(self, req):
        req["slot"] = self._slot
        return self._owner._dispatch_segments([req])[0]

    def _drain(self) -> np.ndarray:
        if not self._out and self._owner._wire_i16 and (self._channels or 1) == 1:
            return np.zeros(0, np.int16)
        return super()._drain()

    def state_dict(self) -> dict:
        """§5.4 for a multiplexed lane: the live analysis/law carries are
        STACKED in the owner (the lane's own copies are the construction-
        time initials) — extract this slot's rows so the snapshot restores
        into a standalone DeviceStreamingPipeline (or another lane)
        bit-identically. k==0 keeps the fresh initial carry: the stacked
        row may still hold a previous occupant's state, which the round
        program's k==0 freshness rule ignores but a standalone pipeline
        would not."""
        d = super().state_dict()
        if self._k > 0:
            d["an_carry"] = [
                np.asarray(a[self._slot]) for a in self._owner._an_carry
            ]
            law = np.asarray(self._owner._law_carry[self._slot])
            d["law_carry"] = (float(law[0]), float(law[1]))
        return d

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        i = self._slot
        self._owner._an_carry = jax.tree_util.tree_map(
            lambda s, row: s.at[i].set(jnp.asarray(row)),
            self._owner._an_carry,
            jax.tree_util.tree_unflatten(
                jax.tree_util.tree_structure(self._owner._an_carry),
                [np.asarray(a) for a in state["an_carry"]],
            ),
        )
        self._owner._law_carry = self._owner._law_carry.at[i].set(
            jnp.asarray(np.asarray(state["law_carry"], np.float32))
        )
        # The device ring holds nothing for this lane yet: mark the whole
        # retained raw window pending so the next round re-uploads it.
        self._ring_fed = self._raw_base
        if self._owner._wire_i16 and self._fed > self._raw_base:
            # Reconstruct the wire payload from the f32 mirror (exact:
            # every retained value is i/2^15, so x*2^15 is an integer).
            mono = self._mono(self._raw[: self._fed - self._raw_base])
            self._wire_pending = [
                np.clip(np.round(mono * 32768.0), -32768, 32767).astype(
                    np.int16
                )
            ]

    def flush(self) -> np.ndarray:
        # The inherited flush trims each chunk's tension to the true
        # T_out; the fused step needs that bound to mask the law's
        # integrator identically (the trimmed frames must never reach
        # it — streaming_device.flush's contract). Pending audio must hit
        # the device ring first: the flush chunk loop reads the ring.
        T = self.cfg.num_frames(self._fed, integer_step=True)
        self._flush_T_out = self.cfg.num_tension_frames(T)
        if self._owner._ring is not None:
            while self._ring_pending() > 0:
                self._owner._dispatch_round([self], write_only=True)
        try:
            return super().flush()
        finally:
            self._owner._release(self._slot)


class MultiStreamPipeline:
    """N concurrent live streams multiplexed into shared fixed-shape
    device dispatches over device-resident audio rings. open() a slot,
    feed()/flush() it like a DeviceStreamingPipeline; feed_many() batches
    several streams' feeds into one pump round (the high-throughput call
    pattern).

    All streams share one plan (cfg, chunk/segment geometry, channel
    count, speed bounds); per-stream rates may differ within the plan's
    bounds. Per-stream outputs equal a standalone
    DeviceStreamingPipeline's with the same parameters: bit for bit on
    the CPU backend (gated); on a GPU the compiler may pick other kernels
    for other row counts, so there they agree to float rounding (see
    PERF.md for the observed gap).

    wire_dtype: "float32" (default; bit-compatible with float feeds) or
    "int16" — the reference's PCM serving format: int16 feeds converted
    on device by x/2^15 (add_data_short), int16 outputs via
    clip(round(x*2^15)) (read_short), halving wire bytes both ways.

    max_feed_samples bounds the per-round upload bucket (larger feeds
    are uploaded across several write rounds) and sizes the device ring;
    device_ring=False selects the host-upload dispatches
    (multichannel pipelines always use them — the ring is mono)."""

    def __init__(
        self,
        cfg: SpeedyConfig,
        global_speed: float,
        n_streams: int = 16,
        nonlinear_factor: float = 1.0,
        duration_feedback_strength: float = 0.1,
        chunk_frames: int = 128,
        segment_frames: int = 512,
        channels: int = 1,
        min_speed_bound: Optional[float] = None,
        max_speed_bound: Optional[float] = None,
        phase_ref_limit: float = float(2**21),
        wire_dtype: str = "float32",
        max_feed_samples: int = 131072,
        device_ring: bool = True,
        out_cap_factor: float = 1.5,
    ):
        assert n_streams >= 1 and channels >= 1
        assert wire_dtype in ("float32", "int16")
        self.cfg = cfg
        self.rg = float(global_speed)
        self.nl = float(nonlinear_factor)
        self.fb = float(duration_feedback_strength)
        self.n_slots = int(n_streams)
        self.channels = int(channels)
        self.Ch = int(chunk_frames)
        self.Fseg = int(segment_frames)
        self.step = cfg.frame_step_int
        self._wire_i16 = wire_dtype == "int16"
        self._wire_np = np.int16 if self._wire_i16 else np.float32
        self.max_feed = int(max_feed_samples)
        assert not (self._wire_i16 and channels > 1), (
            "int16 wire is the mono serving path"
        )
        # Shared plan bounds: every lane is constructed with these
        # EXPLICITLY so per-stream rates cannot fork the static plan.
        if min_speed_bound is None:
            min_speed_bound = (
                1.0 if self.rg >= 1.0 else max(C.MIN_SPEED, 0.3 * self.rg)
            )
        self.min_sb = float(min_speed_bound)
        if max_speed_bound is None:
            max_speed_bound = _plan_max_speed(self.rg, self.nl)
        self.max_sb = float(max_speed_bound)
        self._pr_limit = float(phase_ref_limit)

        self._lanes: List[Optional[_Lane]] = [None] * self.n_slots
        # Observability: device dispatches vs work units they carried —
        # the multiplexing ratio (work / dispatches) is the whole point.
        # ring_fallbacks counts dispatches that aged out of the device
        # ring and took the host-upload path instead. Wire ledger
        # convention: bytes_up = AUDIO payload uploaded; bytes_ctrl =
        # non-audio control operands (speeds/indices/masks) shipped up;
        # bytes_down = everything fetched. Audio vs control are split so
        # the ring regime (audio crosses once, controls every round) and
        # the host-upload regime stay comparable.
        self.stats = {
            "chunk_dispatches": 0,
            "chunks_processed": 0,
            "segment_dispatches": 0,
            "segments_processed": 0,
            "write_rounds": 0,
            "ring_fallbacks": 0,
            "bytes_up": 0,
            "bytes_ctrl": 0,
            "bytes_down": 0,
        }
        self._chunk_step, init_state = _batched_chunk_law_step(
            cfg, self.Ch, self.nl, self.fb
        )
        self._an_carry, self._law_carry = init_state(self.n_slots)

        # Shared segment geometry, derived from a template lane so the
        # WSOLA dispatch's static shapes exist before the first open().
        tmpl = self._make_lane(slot=0, speed=self.rg)
        self.L_seg = tmpl.L_seg
        self.F_in = tmpl.F_in
        self.K_st = tmpl.K_st
        self.capacity = tmpl.capacity

        # Device audio ring (mono serving path). Sized so one segment
        # window plus one round's upload always fits; the host mirror
        # covers the rare historical miss.
        self._ring = None
        if device_ring and self.channels == 1:
            ChS = self.Ch * self.step
            self.R = int(
                -(-(self.L_seg + self.max_feed + 2 * ChS + 1024) // 1024) * 1024
            )
            self._ring = jnp.zeros((self.n_slots, self.R), jnp.float32)
        # Rate-derived output trim for segment downloads: a plan-capacity
        # row is sized for min_speed_bound, but a rate-rg segment's
        # output is ~rg/min_sb x smaller; ship only out_cap samples. The
        # host knows every row's exact need pre-dispatch and lazily
        # compiles the full-capacity variant if it ever exceeds this.
        Hs = self.step
        want = int(out_cap_factor * self.Fseg * self.step / max(self.rg, 1e-6))
        self.out_cap = min(self.capacity, (-(-want // Hs) + 4) * Hs)

    # ---------- slot management ----------

    def _make_lane(self, slot: int, speed: float) -> _Lane:
        return _Lane(
            self,
            slot,
            cfg=self.cfg,
            global_speed=speed,
            nonlinear_factor=self.nl,
            duration_feedback_strength=self.fb,
            chunk_frames=self.Ch,
            segment_frames=self.Fseg,
            min_speed_bound=self.min_sb,
            max_speed_bound=self.max_sb,
            phase_ref_limit=self._pr_limit,
        )

    def open(self, global_speed: Optional[float] = None) -> int:
        """Acquire a free stream slot; returns the stream id. Raises if
        all slots are busy, or if the requested rate needs a larger
        speed-bound plan than this pipeline was constructed with."""
        speed = self.rg if global_speed is None else float(global_speed)
        if not (self.min_sb <= speed and _plan_max_speed(speed, self.nl) <= self.max_sb):
            raise ValueError(
                f"stream rate {speed} outside this pipeline's plan bounds "
                f"[{self.min_sb}, {self.max_sb}]; construct the pipeline "
                "with explicit min/max_speed_bound covering every rate"
            )
        for i, lane in enumerate(self._lanes):
            if lane is None:
                self._lanes[i] = self._make_lane(i, speed)
                return i
        raise RuntimeError(f"all {self.n_slots} stream slots are busy")

    def _release(self, slot: int) -> None:
        self._lanes[slot] = None

    def _lane(self, sid: int) -> _Lane:
        lane = (
            self._lanes[sid] if 0 <= sid < self.n_slots else None
        )
        if lane is None:
            raise KeyError(f"stream {sid} is not open")
        return lane

    @property
    def n_active(self) -> int:
        return sum(l is not None for l in self._lanes)

    # ---------- public stream API ----------

    def _validate_feed(self, samples: np.ndarray) -> np.ndarray:
        """Shared feed()/feed_many() validation. The OWNER's channel
        count is the contract: a standalone pipeline adopts its channel
        count at the first feed, but a multiplexed lane must match the
        pipeline-wide device programs — so a mismatched feed is an
        error here, never a silent downmix."""
        if self.channels > 1:
            samples = np.asarray(samples, np.float32)
            if not (samples.ndim == 2 and samples.shape[1] == self.channels):
                raise ValueError(
                    f"channels={self.channels} pipeline takes "
                    f"[n, {self.channels}] feeds (got shape {np.shape(samples)})"
                )
            return samples
        samples = np.asarray(samples)
        if samples.ndim == 2 and samples.shape[1] == 1:
            samples = samples[:, 0]
        if samples.ndim != 1:
            raise ValueError(
                f"channels=1 pipeline takes 1-D mono feeds (got shape "
                f"{samples.shape}); construct MultiStreamPipeline(channels=C) "
                "for multichannel streams"
            )
        # int16-wire contract checked here too (user-facing validation
        # must survive python -O, so no asserts on this path): lanes
        # convert ÷2^15 in _ingest.
        if self._wire_i16:
            if samples.dtype != np.int16:
                raise TypeError(
                    "wire_dtype='int16' pipelines take int16 PCM feeds "
                    f"(got {samples.dtype}; construct with "
                    "wire_dtype='float32' for float feeds)"
                )
        return samples

    def feed(self, sid: int, samples: np.ndarray) -> np.ndarray:
        """Feed one stream; pump ALL streams' ready work in shared
        dispatches; return this stream's available output."""
        lane = self._lane(sid)
        return lane.feed(self._validate_feed(samples))

    def feed_many(
        self, pairs: Sequence[Tuple[int, np.ndarray]]
    ) -> Dict[int, np.ndarray]:
        """Feed several streams, then run ONE shared pump round — the
        call pattern that maximizes dispatch sharing. Returns each fed
        stream's drained output. Validation is atomic: every pair is
        checked (open stream + feed shape/dtype) before ANY is ingested,
        so an invalid pair cannot leave earlier pairs half-applied."""
        validated = [
            (self._lane(sid), self._validate_feed(samples))
            for sid, samples in pairs
        ]
        for lane, samples in validated:
            lane._ingest(samples)
        self._pump_all()
        return {sid: self._lane(sid)._drain() for sid, _ in pairs}

    def set_speed(self, sid: int, global_speed: float) -> None:
        """sonicSetSpeed semantics per stream. Like
        DeviceStreamingPipeline.set_speed, instantaneous speeds remain
        clamped to the plan bounds fixed at construction — pass a larger
        max_speed_bound up front to raise rates beyond the initial
        plan's ceiling (identical clamping in a standalone pipeline with
        the same bounds, so bit-equality is preserved either way)."""
        self._lane(sid).set_speed(global_speed)

    def flush(self, sid: int) -> np.ndarray:
        """Drain the stream's tail and release its slot."""
        return self._lane(sid).flush()

    def state_dict(self, sid: int) -> dict:
        """Snapshot one stream's complete state (§5.4): restores into a
        standalone DeviceStreamingPipeline or into a fresh lane of any
        MultiStreamPipeline (same plan parameters) bit-identically —
        the mid-stream failover/resume primitive (gated by
        test_multistream_lane_checkpoint_resume)."""
        return self._lane(sid).state_dict()

    def load_state_dict(self, sid: int, state: dict) -> None:
        """Restore a snapshot into stream `sid` (a freshly opened slot);
        the stream continues bit-identically from the snapshot point."""
        self._lane(sid).load_state_dict(state)

    # ---------- shared dispatch machinery ----------

    def _active_lanes(self) -> List[_Lane]:
        return [l for l in self._lanes if l is not None]

    def _pump_all(self) -> None:
        lanes = self._active_lanes()
        if self._ring is not None:
            # Ring rounds: write pending uploads + run ready chunks until
            # both drain (a round is capped at max_feed upload samples
            # and NC chunks per lane; the loop covers bursts).
            while True:
                work = [
                    l
                    for l in lanes
                    if l._ring_pending() > 0 or self._lane_chunks_ready(l) > 0
                ]
                if not work:
                    break
                outs = self._dispatch_round(work)
                for l, per_chunk in zip(work, outs):
                    for t, sp in per_chunk:
                        l._k += 1
                        l._pending_speeds = sp
                        l._extend_speeds(t)
        else:
            while True:
                items = [
                    (l, l._chunk_samples()) for l in lanes if l._analysis_ready()
                ]
                if not items:
                    break
                outs = self._dispatch_chunks(items)
                for (l, _), (t, sp) in zip(items, outs):
                    l._k += 1
                    l._pending_speeds = sp
                    l._extend_speeds(t)
        # WSOLA rounds: every lane with a full segment of speeds + the
        # synthesis-reach margin of raw audio advances one segment.
        while True:
            ready = [l for l in lanes if l._segment_ready()]
            if not ready:
                break
            prepped = [
                l._prep_wsola_segment(l._f_done + l.Fseg, None) for l in ready
            ]
            for l, (req, _) in zip(ready, prepped):
                req["slot"] = l._slot
            outs = self._dispatch_segments([req for req, _ in prepped])
            for l, (_, meta), (y, p) in zip(ready, prepped, outs):
                l._finish_wsola_segment(meta, y, p)

    def _lane_chunks_ready(self, lane: _Lane) -> int:
        """Chunks whose samples are (or will be, after this round's
        write) fully in the device ring."""
        ChS = self.Ch * self.step
        covered = lane._ring_fed + min(lane._ring_pending(), self.max_feed)
        return max(0, covered // ChS - lane._k)

    @staticmethod
    def _u_bucket(n: int) -> int:
        # U=0 is a stable cached shape of its own: flush-path force_one
        # rounds have nothing pending, and shipping the 32768-wide zero
        # bucket anyway cost ~4 MB of dead wire per flush chunk at N=32.
        return 0 if n == 0 else max(32768, -(-n // 32768) * 32768)

    def _dispatch_round(
        self, lanes: Sequence[_Lane], force_one: bool = False,
        write_only: bool = False,
    ) -> List[List[Tuple[np.ndarray, np.ndarray]]]:
        """One ring ROUND over all slots: upload + ring-write the lanes'
        pending audio and run their ready chunks. Returns, per lane, the
        list of (lo-trimmed dummy-tension row, speeds row) per chunk run
        — the same per-chunk convention as _dispatch_chunks (tension
        content is consumed on device; only its length carries host
        meaning). force_one: run exactly one chunk per lane regardless
        of the fed watermark (the flush loop's zero-padded chunks);
        write_only: upload pending without running chunks."""
        N = self.n_slots
        ChS = self.Ch * self.step
        pend = {l._slot: l._take_pending(self.max_feed) for l in lanes}
        u_max = max((p.size for p in pend.values()), default=0)
        U = self._u_bucket(u_max)
        new = np.zeros((N, U), self._wire_np)
        n_new = np.zeros((N,), np.int32)
        hi = np.zeros((N,), np.int32)
        k0 = np.zeros((N,), np.int32)
        n_ch = np.zeros((N,), np.int32)
        rgs = np.ones((N,), np.float32)
        t_cap = np.full((N,), 2**30, np.int32)
        NC = 1 if force_one else U // ChS + 2
        metas = []
        for l in lanes:
            i = l._slot
            p = pend[i]
            assert l._fed < _ABS_LIMIT, (
                "stream exceeded the int32 absolute-position bound "
                "(~2^31 samples); flush and reopen the slot"
            )
            new[i, : p.size] = p
            n_new[i] = p.size
            covered = l._ring_fed + p.size
            hi[i] = covered
            k0[i] = l._k
            # Chunk windows must still be inside the sliding window.
            assert l._k * ChS >= covered - self.R, (
                "analysis backlog aged out of the device window "
                f"(k={l._k}, covered={covered}, R={self.R})"
            )
            if force_one:
                nc = 1
            elif write_only:
                nc = 0
            else:
                nc = min(NC, max(0, covered // ChS - l._k))
            n_ch[i] = nc
            rgs[i] = l.rg
            if l._flush_T_out is not None:
                t_cap[i] = l._flush_T_out
            metas.append((l, i, int(l._k), nc, int(t_cap[i])))
        step_fn = _ring_round_step(
            self.cfg, self.Ch, self.nl, self.fb, self.R, U, NC, self._wire_i16
        )
        self._ring, self._an_carry, self._law_carry, speeds = step_fn(
            self._ring,
            self._an_carry,
            self._law_carry,
            new,
            jnp.asarray(n_new),
            jnp.asarray(hi),
            jnp.asarray(k0),
            jnp.asarray(n_ch),
            jnp.asarray(rgs),
            jnp.asarray(t_cap),
        )
        for l in lanes:
            l._ring_fed += int(pend[l._slot].size)
        total_chunks = int(n_ch.sum())
        self.stats["write_rounds"] += 1
        # bytes_up is the AUDIO payload; control operands are ledgered
        # separately in bytes_ctrl so the ring and host regimes stay
        # comparable.
        self.stats["bytes_up"] += int(new.nbytes)
        self.stats["bytes_ctrl"] += int(
            n_new.nbytes
            + hi.nbytes
            + k0.nbytes
            + n_ch.nbytes
            + rgs.nbytes
            + t_cap.nbytes
        )
        if total_chunks > 0:
            self.stats["chunk_dispatches"] += 1
            self.stats["chunks_processed"] += total_chunks
            s_host = np.asarray(speeds)  # [N, NC, Ch]
            self.stats["bytes_down"] += int(s_host.nbytes)
        out: List[List[Tuple[np.ndarray, np.ndarray]]] = []
        fut = self.cfg.hysteresis_future
        for l, i, k_base, nc, cap in metas:
            per_chunk = []
            for c in range(nc):
                k = k_base + c
                g0 = k * self.Ch - 2 - fut
                lo = max(0, -g0)
                hi_j = min(self.Ch, max(lo, cap - g0))
                t_row = np.zeros(self.Ch - lo, np.float32)
                per_chunk.append((t_row, s_host[i, c, lo:hi_j]))
            out.append(per_chunk)
        return out

    def _dispatch_chunks(
        self, items: Sequence[Tuple[_Lane, np.ndarray]]
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """One fused analysis+law dispatch over all slots (HOST-UPLOAD
        path: multichannel pipelines or device_ring=False); `items` rows
        are valid, the rest are masked. Returns per item the lo-trimmed
        tension row and the [lo:hi) speeds row (hi < Ch only under the
        flush-time T_out cap)."""
        N, Ch = self.n_slots, self.Ch
        ks = np.ones((N,), np.int32)  # dummy rows: k=1 keeps use0 off
        samples = np.zeros((N, Ch * self.step), np.float32)
        rgs = np.ones((N,), np.float32)
        los = np.zeros((N,), np.int32)
        his = np.zeros((N,), np.int32)
        valids = np.zeros((N,), bool)
        metas = []
        for l, s in items:
            i = l._slot
            k = l._k
            ks[i] = k
            samples[i] = s
            rgs[i] = l.rg
            lo = max(0, -(k * Ch - 2 - l.fut))
            if l._flush_T_out is None:
                hi = Ch
            else:
                hi = min(Ch, lo + max(0, l._flush_T_out - l._t_emitted))
            los[i] = lo
            his[i] = hi
            valids[i] = True
            metas.append((i, lo, hi))
        self._an_carry, self._law_carry, tension, speeds = self._chunk_step(
            self._an_carry,
            self._law_carry,
            jnp.asarray(ks),
            jnp.asarray(samples),
            jnp.asarray(rgs),
            jnp.asarray(los),
            jnp.asarray(his),
            jnp.asarray(valids),
        )
        self.stats["chunk_dispatches"] += 1
        self.stats["chunks_processed"] += len(items)
        self.stats["bytes_up"] += int(samples.nbytes)
        self.stats["bytes_ctrl"] += int(
            ks.nbytes + rgs.nbytes + los.nbytes + his.nbytes + valids.nbytes
        )
        t_host = np.asarray(tension)
        s_host = np.asarray(speeds)
        self.stats["bytes_down"] += int(t_host.nbytes + s_host.nbytes)
        return [(t_host[i, lo:], s_host[i, lo:hi]) for (i, lo, hi) in metas]

    def _dispatch_segments(self, reqs: Sequence[dict]) -> List[Tuple[np.ndarray, np.ndarray]]:
        """One grid-WSOLA dispatch over all slots (fixed shape [N, ...]);
        rows beyond len(reqs) are zero-length dummies. Sourced from the
        device ring when every row's window is still resident (falls
        back to the host-upload path otherwise). Returns (output row,
        period row) per request."""
        N = self.n_slots
        use_ring = self._ring is not None and all(
            r.get("seg_ch") is None
            and r["s0"] >= 0
            and r["fed"] - r["s0"] <= self.R
            for r in reqs
        )
        if not use_ring:
            if self._ring is not None:
                self.stats["ring_fallbacks"] += 1
            return self._dispatch_segments_host(reqs)

        # The ring is indexed by SLOT: every request's controls must land
        # on its lane's ring row (the host path's rows are self-contained
        # so it never needed the mapping).
        s0 = np.zeros((N,), np.int32)
        lo = np.zeros((N,), np.int32)
        hi = np.zeros((N,), np.int32)
        lens = np.zeros((N,), np.int32)
        sps = np.ones((N, self.F_in), np.float32)
        ino = np.zeros((N,), np.float32)
        osh = np.zeros((N,), np.float32)
        prf = np.zeros((N,), np.float32)
        needed = 0
        slots = [r["slot"] for r in reqs]
        for i, r in zip(slots, reqs):
            s0[i] = r["s0"]
            lo[i] = r["src_lo"]
            hi[i] = r["fed"]
            lens[i] = r["seg_len"]
            sps[i] = r["sp"]
            ino[i] = r["in_offset"]
            osh[i] = r["out_shift"]
            prf[i] = r["phase_ref"]
            needed = max(needed, int(r.get("out_need", self.capacity)))
        out_cap = self.out_cap if needed <= self.out_cap else self.capacity
        step_fn = _ring_seg_step(
            self.cfg,
            self.R,
            self.L_seg,
            self.F_in,
            self.K_st,
            self.capacity,
            out_cap,
            self.step,
            self.step,  # hop == frame step: the streaming plan invariant
            self.max_sb,
            self._wire_i16,
        )
        y_d, p_d = step_fn(
            self._ring,
            jnp.asarray(s0),
            jnp.asarray(lo),
            jnp.asarray(hi),
            jnp.asarray(lens),
            jnp.asarray(sps),
            jnp.asarray(ino),
            jnp.asarray(osh),
            jnp.asarray(prf),
        )
        y, p = jax.device_get((y_d, p_d))
        self.stats["segment_dispatches"] += 1
        self.stats["segments_processed"] += len(reqs)
        # Ring rounds ship no audio up, but the control vectors (sps is
        # [N, F_in] f32, the dominant one) still cross the wire — ledger
        # them so the ring and host-upload regimes are comparable.
        self.stats["bytes_ctrl"] += int(
            s0.nbytes
            + lo.nbytes
            + hi.nbytes
            + lens.nbytes
            + sps.nbytes
            + ino.nbytes
            + osh.nbytes
            + prf.nbytes
        )
        self.stats["bytes_down"] += int(y.nbytes + p.nbytes)
        return [(y[i], p[i]) for i in slots]

    def _dispatch_segments_host(
        self, reqs: Sequence[dict]
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Host-upload WSOLA dispatch (multichannel / ring-miss path)."""
        N = self.n_slots
        segs = np.zeros((N, self.L_seg), np.float32)
        lens = np.zeros((N,), np.int32)
        sps = np.ones((N, self.F_in), np.float32)
        ino = np.zeros((N,), np.float32)
        osh = np.zeros((N,), np.float32)
        prf = np.zeros((N,), np.float32)
        seg_ch = (
            np.zeros((N, self.channels, self.L_seg), np.float32)
            if self.channels > 1
            else None
        )
        for i, r in enumerate(reqs):
            if r["seg"] is None:
                # Lazy ring-lane request: rebuild the host window from
                # the lane's raw mirror (same pump round, so the mirror
                # still covers the span the prep step saw).
                r["seg"], r["seg_ch"] = self._lanes[r["slot"]]._build_seg_window(
                    int(r["s0"])
                )
            segs[i] = r["seg"]
            lens[i] = r["seg_len"]
            sps[i] = r["sp"]
            ino[i] = r["in_offset"]
            osh[i] = r["out_shift"]
            prf[i] = r["phase_ref"]
            if seg_ch is not None:
                assert r["seg_ch"] is not None, "mono feed on a multichannel pipeline"
                seg_ch[i] = r["seg_ch"].T
        res, periods = wsola_fast._wsola_grid_batch(
            jnp.asarray(segs),
            jnp.asarray(lens),
            jnp.asarray(sps),
            self.cfg.wsola_min_period,
            self.cfg.wsola_max_period,
            self.step,
            self.step,  # hop == frame step: the streaming plan invariant
            self.capacity,
            self.K_st,
            xs_channels=None if seg_ch is None else jnp.asarray(seg_ch),
            max_speed_plan=self.max_sb,
            in_offset=jnp.asarray(ino),
            out_shift=jnp.asarray(osh),
            phase_ref=jnp.asarray(prf),
            mask_output=False,
            return_period=True,
        )
        self.stats["segment_dispatches"] += 1
        self.stats["segments_processed"] += len(reqs)
        # Ledger the major operands so the wire counters stay honest in
        # the fallback regime too (segs/seg_ch/speeds up; rows down).
        self.stats["bytes_up"] += int(
            segs.nbytes + (seg_ch.nbytes if seg_ch is not None else 0)
        )
        self.stats["bytes_ctrl"] += int(
            sps.nbytes + lens.nbytes + ino.nbytes + osh.nbytes + prf.nbytes
        )
        y = np.asarray(res.output)
        p = np.asarray(periods)
        self.stats["bytes_down"] += int(y.nbytes + p.nbytes)
        if self._wire_i16:
            y = np.clip(np.round(y * 32768.0), -32768, 32767).astype(np.int16)
        return [(y[i], p[i]) for i in range(len(reqs))]
