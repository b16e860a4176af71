"""Unbounded wav -> wav nonlinear speedup on device with bounded memory.

`DeviceStreamingPipeline` is the serving-side composition of the O(1)-state
building blocks: arbitrarily long audio streams through fixed-size jitted
device programs —

  1. ANALYSIS: the chunked scan step (ops/chunked.py::make_chunk_step)
     carrying the reference's ring state (~4 KB);
  2. SPEED LAW: ops/speed.py::speed_from_tension seeded with the carried
     duration integrator (the law is O(1)-state by construction);
  3. WSOLA: the grid engine (ops/wsola_fast.py) called per SEGMENT with
     the streaming-continuation hooks (in_offset / out_shift / phase_ref /
     mask_output=False), so consecutive segments share one global output
     clock and phase-snap reference.

Seamlessness is by construction, not crossfading: segment k's first local
chunk is the PREVIOUS segment's last emitted chunk recomputed (its slot is
dropped; only its windowed second half feeds the overlap-add of the first
emitted slot), and the segment source buffer starts on a pitch-grid
multiple (wsola_fast.pitch_grid_stride) so every source position's pitch
estimate is identical in every segment. The two computations of the shared
chunk agree to float-ulp, so the seam is invisible — gated by the
single-shot-equality and Teager tests in tests/test_streaming_device.py.

Host memory is bounded by one segment plus margins (raw ring buffer,
pruned as both cursors advance); device memory by the per-segment program
shapes. The reference's own streaming shim is O(1)-state sample-serial C
(soniclib.c:427-450); this is its corpus-throughput-grade device analog.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import config as C
from .config import SpeedyConfig
from .ops import wsola_fast
from .ops.chunked import make_chunk_step
from .ops.speed import speed_from_tension


@functools.lru_cache(maxsize=16)
def _jitted_chunk_step(cfg: SpeedyConfig, chunk_frames: int):
    """One compiled analysis step per (config, chunk size) — shared by
    every pipeline instance (a per-instance jit cache would recompile
    per stream)."""
    carry0, body = make_chunk_step(cfg, chunk_frames)
    return carry0, jax.jit(body)


class DeviceStreamingPipeline:
    """Streaming nonlinear speedup: feed() audio chunks of any size,
    receive sped-up audio incrementally; flush() drains the tail at the
    last computed speed (the shim's flush contract, soniclib.c:529-552).

    Mono float32 (±1) in/out. One jitted program per (analysis-chunk,
    segment) shape — independent of total stream length.
    """

    # Analysis frames per device chunk and WSOLA frames per device segment.
    def __init__(
        self,
        cfg: SpeedyConfig,
        global_speed: float,
        nonlinear_factor: float = 1.0,
        duration_feedback_strength: float = 0.1,
        chunk_frames: int = 128,
        segment_frames: int = 512,
        min_speed_bound: Optional[float] = None,
        max_speed_bound: Optional[float] = None,
        phase_ref_limit: float = float(2**21),
    ):
        self.cfg = cfg
        self.rg = float(global_speed)
        self.nl = float(nonlinear_factor)
        self.fb = float(duration_feedback_strength)
        self.step = cfg.frame_step_int
        self.W = cfg.window_size
        self.fut = cfg.hysteresis_future
        self.Ch = chunk_frames
        self.Fseg = segment_frames
        self.Hs = max(32, self.step)
        assert self.Hs == self.step, "streaming assumes hop == frame step"
        if min_speed_bound is None:
            min_speed_bound = (
                1.0 if self.rg >= 1.0 else max(C.MIN_SPEED, 0.3 * self.rg)
            )
        self.min_sb = float(min_speed_bound)
        if max_speed_bound is None:
            from .parallel.batch import _plan_max_speed

            max_speed_bound = _plan_max_speed(self.rg, self.nl)
        self.max_sb = float(max_speed_bound)

        # --- static segment geometry ---
        self.G = wsola_fast.pitch_grid_stride(cfg, self.Hs)
        maxp = cfg.wsola_max_period
        self.LOOKBACK = max(32, int(2 * self.max_sb) + 8)
        self.F_in = self.Fseg + self.LOOKBACK
        self.front_margin = maxp + 64
        self.back_margin = self.G // 2 + 2 * maxp + 2 * self.Hs + 64
        L_need = (
            self.front_margin
            + self.G  # s0 alignment slack
            + self.F_in * self.step
            + self.back_margin
        )
        self.L_seg = -(-L_need // self.G) * self.G
        n_slots_max = int(np.ceil(self.Fseg / self.min_sb)) + 2
        self.K_st = n_slots_max + 4
        self.capacity = (self.K_st - 1) * self.Hs

        # --- device programs (compiled lazily; caches shared across
        # instances) ---
        carry0, self._an_step = _jitted_chunk_step(cfg, self.Ch)
        self._an_carry = carry0

        # --- mutable stream state ---
        self._channels: Optional[int] = None  # fixed at first feed()
        self._raw = np.zeros((0, 1), np.float32)  # retained samples [N, C]
        self._raw_base = 0                   # global index of _raw[0]
        self._fed = 0                        # total samples fed
        self._k = 0                          # analysis chunks run
        self._t_emitted = 0                  # tension frames produced
        self._speeds: List[float] = []       # per-frame speeds (clamped)
        self._obnd = [0.0]                   # float64 output prefix per frame
        self._sp_base = 0                    # frame index of _speeds[0]
        self._law_carry = (0.0, 0.0)         # duration integrator
        self._f_done = 0                     # frames consumed by WSOLA
        self._S = 0                          # output slots emitted
        # Phase-reference re-basing: the absolute reference S*Hs - s0
        # grows ~|1-rate| x stream position, and a large f32 value makes
        # the engine's delta-mod-period arithmetic lose sample-scale
        # precision (f32 spacing at 2^24 is 2 samples). The host keeps an
        # exact float64 base subtracted from the reference; whenever the
        # reduced reference exceeds phase_ref_limit, the base advances by
        # an EXACT multiple of the segment-boundary chunk's pitch period
        # (returned by the engine), which leaves that shared chunk's
        # phase-snap bit-unchanged — other chunks re-anchor, which is the
        # same class of event as the engine's own pitch-cell transitions.
        self._pr_limit = float(phase_ref_limit)
        self._pr_base = 0.0                  # float64, exact
        self._periods_prev: Optional[np.ndarray] = None  # [K] last segment
        self._S_local0_prev = 0
        self._out: List[np.ndarray] = []     # drained output chunks
        self._flushed = False

    # ---------- internals ----------

    def _analysis_ready(self) -> bool:
        return (self._k + 1) * self.Ch * self.step <= self._fed

    def _run_analysis_chunk(self, samples: np.ndarray):
        carry, tension = self._an_step(
            self._an_carry, (jnp.asarray(self._k, jnp.int32), jnp.asarray(samples))
        )
        self._an_carry = carry
        t = np.asarray(tension)
        # Chunk k emits tension frames [k*Ch - 2 - fut, (k+1)*Ch - 2 - fut).
        t0 = self._k * self.Ch - 2 - self.fut
        lo = max(0, -t0)
        self._k += 1
        return t[lo:]

    def set_speed(self, global_speed: float) -> None:
        """Change the global rate mid-stream (sonicSetSpeed semantics:
        speedyComputeSpeedFromTension takes R_g per call, so the law
        simply uses the new rate for frames computed after this point;
        the duration integrator carries across). Instantaneous speeds
        remain clamped to the plan bounds fixed at construction — pass a
        larger max_speed_bound up front if you intend to raise the rate
        beyond the initial plan's ceiling."""
        self.rg = float(global_speed)

    def _extend_speeds(self, tension: np.ndarray):
        if tension.size == 0:
            return
        speeds, carry = speed_from_tension(
            jnp.asarray(tension, jnp.float32),
            self.rg,
            self.fb,
            self.nl,
            initial_durations=self._law_carry,
        )
        self._law_carry = (float(carry[0]), float(carry[1]))
        sp = np.clip(np.asarray(speeds, np.float64), self.min_sb, self.max_sb)
        for s in sp:
            self._speeds.append(float(s))
            self._obnd.append(self._obnd[-1] + self.step / float(s))
        self._t_emitted += tension.size

    def _obnd_at(self, frame: int) -> float:
        return self._obnd[frame - self._sp_base]

    def _speed_at(self, frame: int) -> float:
        i = frame - self._sp_base
        return self._speeds[min(i, len(self._speeds) - 1)]

    def _frames_with_speeds(self) -> int:
        return self._sp_base + len(self._speeds)

    def _segment_ready(self) -> bool:
        f_hi = self._f_done + self.Fseg
        if self._frames_with_speeds() < f_hi:
            return False
        # Raw audio must cover the synthesis reach past the segment end.
        return self._fed >= f_hi * self.step + self.back_margin

    def _prep_wsola_segment(self, f_hi: int, out_total: Optional[float]):
        """Host-side assembly of one WSOLA segment dispatch: returns
        (req, meta) where req holds the per-row device inputs (the
        batchable part — multistream.py stacks N of these into one
        dispatch) and meta the host bookkeeping _finish_wsola_segment
        needs. Mutates the phase-re-base state (ordering identical to the
        former inline form)."""
        Hs, step = self.Hs, self.step
        S = self._S
        S_local0 = max(S - 1, 0)
        # Owner frame of output position S_local0*Hs.
        f_lo = self._f_done
        target = S_local0 * Hs
        while f_lo > self._sp_base and self._obnd_at(f_lo) > target:
            f_lo -= 1
        assert self._f_done - f_lo <= self.LOOKBACK, (self._f_done, f_lo)

        # Aligned source window.
        src_lo = max(0, f_lo * step - self.front_margin)
        s0 = (src_lo // self.G) * self.G
        nch = self._raw.shape[1]
        avail_lo = max(s0, self._raw_base)
        seg_len = min(self.L_seg, max(0, self._fed - s0))
        if getattr(self, "_lazy_seg", False) and nch == 1:
            # Multistream ring lanes: the device ring serves the hot
            # path, so skip materializing the host window; the ring-miss
            # fallback rebuilds it from the raw mirror in the SAME pump
            # round (no pruning in between) via _build_seg_window.
            seg = None
            seg_ch = None
        else:
            seg, seg_ch = self._build_seg_window(s0)

        sp = np.empty(self.F_in, np.float32)
        for i in range(self.F_in):
            sp[i] = self._speed_at(f_lo + i)

        S_next = int(self._obnd_at(f_hi) / Hs)
        if out_total is not None:
            S_next = max(S_next, S)  # flush may emit a final partial slot

        phase_ref = float(S_local0) * Hs - float(s0) - self._pr_base
        if abs(phase_ref) > self._pr_limit and self._periods_prev is not None:
            idx = min(
                max(0, S_local0 - self._S_local0_prev),
                len(self._periods_prev) - 1,
            )
            p_sh = float(self._periods_prev[idx])
            k_red = round(phase_ref / p_sh)
            self._pr_base += k_red * p_sh  # float64: exact given f32 p_sh
            phase_ref -= k_red * p_sh

        # out_need: the exact output-row prefix _finish_wsola_segment
        # will read (emit_from + n_emit) — lets the multistream ring
        # dispatch ship a rate-derived trim instead of plan capacity.
        if out_total is None:
            out_need = (S_next - S_local0) * Hs
        else:
            out_need = (S - S_local0) * Hs + max(
                0, int(round(out_total)) - S * Hs
            )
        req = {
            "seg": seg,
            "seg_ch": seg_ch,
            "seg_len": seg_len,
            "sp": sp,
            "in_offset": float(f_lo * step - s0),
            "out_shift": float(S_local0 * Hs - self._obnd_at(f_lo)),
            "phase_ref": float(phase_ref),
            # Ring-dispatch sourcing (multistream.py): the absolute
            # window start, the zeroing bounds the host builder applied,
            # and the emit prefix bound.
            "s0": int(s0),
            "src_lo": int(avail_lo),
            "fed": int(self._fed),
            "out_need": int(out_need),
        }
        meta = (S, S_local0, S_next, out_total, f_hi, f_lo, nch)
        return req, meta

    def _build_seg_window(self, s0: int):
        """Materialize the [L_seg] host source window starting at
        absolute sample s0 from the raw mirror (zeros outside the
        retained [raw_base, fed) span). Returns (mono seg, seg_ch or
        None for mono)."""
        nch = self._raw.shape[1]
        seg_ch = np.zeros((self.L_seg, nch), np.float32)
        avail_lo = max(s0, self._raw_base)
        avail_hi = min(s0 + self.L_seg, self._raw_base + len(self._raw))
        if avail_hi > avail_lo:
            seg_ch[avail_lo - s0 : avail_hi - s0] = self._raw[
                avail_lo - self._raw_base : avail_hi - self._raw_base
            ]
        return self._mono(seg_ch), (seg_ch if nch > 1 else None)

    def _wsola_dispatch(self, req):
        """One single-row device dispatch of a prepared segment request.
        Overridden by multistream._Lane to route through the shared
        fixed-shape batched program."""
        res, periods = wsola_fast._wsola_grid_batch(
            jnp.asarray(req["seg"])[None],
            jnp.asarray([req["seg_len"]], jnp.int32),
            jnp.asarray(req["sp"])[None],
            self.cfg.wsola_min_period,
            self.cfg.wsola_max_period,
            self.step,
            self.Hs,
            self.capacity,
            self.K_st,
            xs_channels=(
                jnp.asarray(req["seg_ch"].T)[None]
                if req["seg_ch"] is not None
                else None
            ),
            max_speed_plan=self.max_sb,
            in_offset=jnp.asarray([req["in_offset"]], jnp.float32),
            out_shift=jnp.asarray([req["out_shift"]], jnp.float32),
            phase_ref=jnp.asarray([req["phase_ref"]], jnp.float32),
            mask_output=False,
            return_period=True,
        )
        return np.asarray(res.output[0]), np.asarray(periods[0])

    def _finish_wsola_segment(self, meta, y: np.ndarray, periods: np.ndarray):
        """Consume one dispatched segment's output row: emit the owned
        slots, advance the output clock, prune host buffers."""
        S, S_local0, S_next, out_total, f_hi, f_lo, nch = meta
        Hs, step = self.Hs, self.step
        self._periods_prev = periods
        self._S_local0_prev = S_local0
        emit_from = (S - S_local0) * Hs  # 0 for the first segment, Hs after
        if out_total is None:
            n_emit = (S_next - S) * Hs
        else:
            n_emit = max(0, int(round(out_total)) - S * Hs)
        if n_emit > 0:
            piece = y[..., emit_from : emit_from + n_emit]
            self._out.append(
                piece.T.copy() if nch > 1 else piece.copy()
            )
        self._S = S_next
        self._f_done = f_hi

        # Prune host buffers: keep raw/speeds back to the earliest the
        # next segment can need.
        keep_frame = max(self._sp_base, f_lo - self.LOOKBACK)
        drop = keep_frame - self._sp_base
        if drop > 0:
            del self._speeds[:drop]
            del self._obnd[:drop]
            self._sp_base = keep_frame
        keep_raw = max(
            self._raw_base,
            (keep_frame * step - self.front_margin - self.G) // self.G * self.G,
        )
        if keep_raw > self._raw_base:
            self._raw = self._raw[keep_raw - self._raw_base :]
            self._raw_base = keep_raw

    def _run_wsola_segment(self, f_hi: int, out_total: Optional[float]):
        """Synthesize global output slots [S, S_next) using frames up to
        f_hi; out_total (flush only) caps the emitted samples."""
        req, meta = self._prep_wsola_segment(f_hi, out_total)
        y, periods = self._wsola_dispatch(req)
        self._finish_wsola_segment(meta, y, periods)

    def _chunk_samples(self) -> np.ndarray:
        """The next analysis chunk's mono samples (chunk index self._k)."""
        a0 = self._k * self.Ch * self.step
        a1 = a0 + self.Ch * self.step
        return self._mono(self._raw[a0 - self._raw_base : a1 - self._raw_base])

    def _mono(self, rows: np.ndarray) -> np.ndarray:
        """Channel-average mixdown for analysis (the shim's contract,
        soniclib.c:262-287; matches the multichannel batch engine)."""
        return rows.mean(axis=1) if rows.shape[1] > 1 else rows[:, 0]

    def _pump(self):
        while self._analysis_ready():
            self._extend_speeds(self._run_analysis_chunk(self._chunk_samples()))
        while self._segment_ready():
            self._run_wsola_segment(self._f_done + self.Fseg, None)

    def _drain(self) -> np.ndarray:
        if not self._out:
            nch = self._channels or 1
            return (
                np.zeros(0, np.float32)
                if nch == 1
                else np.zeros((0, nch), np.float32)
            )
        out = np.concatenate(self._out)
        self._out = []
        return out

    # ---------- public API ----------

    def _ingest(self, samples: np.ndarray) -> None:
        """Append audio to the raw ring without pumping (multistream.py
        buffers several streams' feeds before one shared pump)."""
        assert not self._flushed, "stream already flushed"
        samples = np.asarray(samples, np.float32)
        if samples.ndim == 1:
            samples = samples[:, None]
        if self._channels is None:
            self._channels = samples.shape[1]
            self._raw = np.zeros((0, self._channels), np.float32)
        assert samples.shape[1] == self._channels, "channel count changed"
        self._raw = np.concatenate([self._raw, samples])
        self._fed += len(samples)

    def feed(self, samples: np.ndarray) -> np.ndarray:
        """Append audio ([N] mono or [N, C] multichannel; C fixed at the
        first call); return whatever output became available (same
        channel shape). Channels are resynthesized with the mixdown-
        derived positions — the shim's multichannel contract."""
        self._ingest(samples)
        self._pump()
        return self._drain()

    def flush(self) -> np.ndarray:
        """Drain the tail: remaining frames run at the last computed speed
        (soniclib.c:538-551), the final partial frame at that speed too."""
        assert not self._flushed
        self._flushed = True
        total = self._fed
        T = self.cfg.num_frames(total, integer_step=True)
        T_out = self.cfg.num_tension_frames(T)
        # Zero-pad the RAW buffer (not _fed: segment validity stays the
        # true length) so every analysis chunk covering T frames can run;
        # then trim the padded chunks' tension to the true T_out — frames
        # past it are computed from pad zeros and must not reach the speed
        # law's duration integrator.
        n_chunks = -(-(T + 2) // self.Ch) if T > 0 else 0
        need = n_chunks * self.Ch * self.step + self.L_seg
        if self._raw_base + len(self._raw) < need:
            nch = self._raw.shape[1]
            self._raw = np.concatenate(
                [
                    self._raw,
                    np.zeros(
                        (need - self._raw_base - len(self._raw), nch),
                        np.float32,
                    ),
                ]
            )
        while self._k < n_chunks:
            t = self._run_analysis_chunk(self._chunk_samples())
            t = t[: max(0, T_out - self._t_emitted)]
            self._extend_speeds(t)
        # Total WSOLA frames = the shim's full-frame count; speeds beyond
        # tension hold the last value (flush-at-last-speed).
        total_frames = total // self.step
        last_speed = (
            self._speeds[-1]
            if self._speeds
            else float(np.clip(self.rg, self.min_sb, self.max_sb))
        )
        tail = total - total_frames * self.step
        # obnd indexing must extend past total_frames for segment math.
        while self._frames_with_speeds() < total_frames + self.F_in:
            self._speeds.append(float(last_speed))
            self._obnd.append(self._obnd[-1] + self.step / float(last_speed))
        out_total = self._obnd_at(total_frames) + tail / float(last_speed)
        # Final segments.
        while self._f_done + self.Fseg <= total_frames:
            self._run_wsola_segment(self._f_done + self.Fseg, None)
        self._run_wsola_segment(total_frames, out_total)
        return self._drain()

    def state_dict(self) -> dict:
        """Snapshot the full stream state as host arrays/scalars — the
        §5.4 checkpoint/resume contract for the device pipeline: a stream
        restored from this dict continues bit-identically (the analysis
        scan carry, speed-law integrator, output clock, phase base, and
        ring buffers are the complete state)."""
        return {
            "params": self._compat_params(),
            "an_carry": [np.asarray(a) for a in self._an_carry],
            "channels": self._channels,
            "raw": self._raw.copy(),
            "raw_base": self._raw_base,
            "fed": self._fed,
            "k": self._k,
            "t_emitted": self._t_emitted,
            "speeds": list(self._speeds),
            "obnd": list(self._obnd),
            "sp_base": self._sp_base,
            "law_carry": self._law_carry,
            "f_done": self._f_done,
            "S": self._S,
            "rg": self.rg,
            "pr_base": self._pr_base,
            "periods_prev": None
            if self._periods_prev is None
            else self._periods_prev.copy(),
            "S_local0_prev": self._S_local0_prev,
        }

    def _compat_params(self) -> tuple:
        """Everything a snapshot's counters are interpreted against: the
        config and every constructor-derived plan constant. rg/nl/fb are
        runtime state (rg is restored; nl/fb are part of the plan via
        max_sb, so they are pinned here too)."""
        return (
            self.cfg, self.nl, self.fb, self.Ch, self.Fseg,
            self.min_sb, self.max_sb, self._pr_limit,
        )

    def load_state_dict(self, state: dict) -> None:
        """Restore a state_dict() snapshot (see its docstring). Pending
        drained output is not part of the state — call this only after
        consuming feed()'s return value. Raises if the target pipeline's
        plan (config, chunk/segment geometry, speed bounds) differs from
        the snapshot's — counters and clocks are only meaningful against
        the same plan."""
        assert not self._flushed and not self._out
        if tuple(state["params"]) != self._compat_params():
            raise ValueError(
                "state_dict plan mismatch: snapshot "
                f"{state['params']} vs target {self._compat_params()}; "
                "construct the pipeline with identical parameters"
            )
        from .ops.chunked import _Carry

        self._an_carry = _Carry(*(jnp.asarray(a) for a in state["an_carry"]))
        self._channels = state["channels"]
        self._raw = state["raw"].copy()
        self._raw_base = state["raw_base"]
        self._fed = state["fed"]
        self._k = state["k"]
        self._t_emitted = state["t_emitted"]
        self._speeds = list(state["speeds"])
        self._obnd = list(state["obnd"])
        self._sp_base = state["sp_base"]
        self._law_carry = tuple(state["law_carry"])
        self._f_done = state["f_done"]
        self._S = state["S"]
        self.rg = state["rg"]
        self._pr_base = state["pr_base"]
        self._periods_prev = (
            None
            if state["periods_prev"] is None
            else state["periods_prev"].copy()
        )
        self._S_local0_prev = state["S_local0_prev"]

    def process(self, x: np.ndarray, feed_chunk: int = 65536) -> np.ndarray:
        """Convenience: stream x ([N] or [N, C]) through feed()/flush()
        and return the concatenated output."""
        outs = []
        x = np.asarray(x, np.float32)
        for i in range(0, len(x), feed_chunk):
            outs.append(self.feed(x[i : i + feed_chunk]))
        outs.append(self.flush())
        return np.concatenate(outs)
