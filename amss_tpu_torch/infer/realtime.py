"""Low-latency streaming separation for the causal TasNet (c7), a port of
``amss_tpu/infer/realtime.py``.

Audio arrives in fixed-size chunks and separated audio leaves after every
chunk, with

    algorithmic latency = chunk + (filter_len - stride) samples

(the decoder's overlap-add lookahead), and the output equals separating the
whole utterance offline up to the order of float32 sums.

All stream state lives on the device, so a push copies one chunk to the
device and one separated block back, and nothing else waits for the device:

* encoder tail ``[B, lag = filter_len - stride]`` samples: frames the new
  chunk on the offline frame grid (push k yields global frames
  ``[k·hop - ls + 1, (k+1)·hop - ls + 1)``, ``ls = filter_len / stride``);
* smoothing tail ``[B, smooth_len - 1, N]``: the codes the causal smoothing
  of ``models/adapt.py::features`` reads back;
* norm carry ``(count, sum, sumsq)[B]`` (or Welford's ``(count, mean, M2)``
  with ``long_stream``): frame t is normalised by the running statistics of
  all frames <= t (``models/front.py::cumulative_norm``);
* TCN conv state, one tensor ``[B, (P-1)·dilation, H]`` per block
  (``models/tcn.py::tcn_stack_streaming``); zero state is the offline left
  zero padding;
* OLA tail ``[B, S, lag]``: the partial overlap-add of the last frames.

* frame counter ``frame_base``, an int64 scalar: the pre-stream mask (the
  ``ls - 1`` frames before sample 0 in the first push) and the
  end-of-utterance decode mask (frames at or past ``end_frame``) are built
  on the device from it.

``step(state, chunk, end_frame) -> (block, state')`` is a pure function of
the state, so ``infer/export.py`` exports it as one program; a push runs it
and keeps the new state.

Order of sums: every stage runs the multiply-adds of the offline path, but
not always in its order.  The norm's running sums restart at each push and
add the carry's totals after the scan, where the offline scan runs through;
and a product over a push's rows may be blocked otherwise than over the
utterance's.  So the two agree to float32 rounding, not bit for bit.
Overlap-add boundary samples have ``ls`` contributions; at ``ls = 2`` (every
recipe) their two-term sum is the same in either order.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from amss_tpu_torch.models.blstm import dense
from amss_tpu_torch.models.front import cumulative_norm, cumulative_norm_welford
from amss_tpu_torch.models.tcn import dw_state_shapes, tcn_stack_streaming
from amss_tpu_torch.utils.device import resolve_device

_NO_END = np.iinfo(np.int32).max


class RealtimeSeparator:
    """Push fixed-size chunks of B mixture streams; get separated chunks back.

    ``separate_stream(wave)`` is the whole-utterance path (pads the tail,
    trims the output), equal to ``model.separate``.  ``long_stream=True``
    carries the norm in Welford's form for unbounded streams (equal to
    offline to rounding, not bit for bit).  The device is ``cuda`` unless the
    caller names another; with none named and no card present, construction
    raises."""

    def __init__(self, model, chunk_samples: int = 4096, sample_rate: int = 8000,
                 long_stream: bool = False, n_streams: int = 1, device=None):
        c = model.cfg
        f, s = c.front, c.sep
        if not (s.trunk == "tcn" and s.causal):
            raise ValueError("RealtimeSeparator needs sep.trunk='tcn' + causal")
        if s.feature_norm != "cumulative":
            raise ValueError("RealtimeSeparator needs feature_norm='cumulative'")
        if f.kind != "adapt" or f.pool != 1:
            raise ValueError("RealtimeSeparator needs an adapt front with pool=1")
        if f.filter_len % f.stride != 0:
            raise ValueError("filter_len must be a multiple of stride")
        if chunk_samples % f.stride != 0:
            raise ValueError("chunk_samples must be a multiple of stride")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.c = chunk_samples
        self.b = n_streams
        self.stride = f.stride
        self.ls = f.filter_len // f.stride
        self.hop = chunk_samples // f.stride  # frames per push
        if self.hop < max(self.ls - 1, f.smooth_len - 1):
            raise ValueError(
                f"chunk too small: {self.hop} frames/push < front tails "
                f"(ls-1={self.ls - 1}, smooth_len-1={f.smooth_len - 1})")
        self.lag = (self.ls - 1) * f.stride  # output lag (samples)
        self.sample_rate = sample_rate
        self.n_spk = c.nb_speakers
        self.long_stream = long_stream
        self._dw_shapes = dw_state_shapes(s.expansion * s.hidden, s.blocks, s.repeats, s.kernel)
        self._end = None  # (host end frames, their device copy)
        self._state = self._init_state()
        self._pending = None  # (host block, copy-done event) from push_async
        self._warm = False  # the first push ever is booked as warm-up
        self._timed_pushes = 0  # pushes after it, across all streams
        self.warmup_seconds = 0.0
        self.compute_seconds = 0.0

    # ---------------------------------------------------------------- state
    def _init_state(self) -> dict:
        f = self.model.cfg.front
        b, dev = self.b, self.device

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        return {
            "enc_tail": zeros(b, self.lag),
            "smooth_tail": zeros(b, f.smooth_len - 1, f.n_filters),
            "norm_carry": (zeros(b), zeros(b), zeros(b)),
            "dw": [zeros(b, t, ch) for t, ch in self._dw_shapes],
            "ola_tail": zeros(b, self.n_spk, self.lag),
            # global index of the next push's first frame
            "frame_base": torch.tensor(-(self.ls - 1), dtype=torch.int64, device=dev),
        }

    def reset(self) -> None:
        """Start new streams: zero the stream state (the RTF meter persists).
        Carried state belongs to one stream per slot, so call it between
        utterances."""
        self._state = self._init_state()
        self._pending = None

    # ----------------------------------------------------------------- step
    # The stages of a push, in order.  Each reads the state and changes
    # nothing; ``step`` runs them and returns the new state.
    def _masks(self, state: dict, end_frame: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """-> valid [B, hop] (zero on the pre-stream frames) and the decode
        mask, which also zeroes frames at or past each stream's end frame
        (``separate_stream``'s zero-padded tail), as offline."""
        frames = torch.arange(self.hop, dtype=torch.int64, device=end_frame.device)
        g = frames + state["frame_base"]  # [hop] global frame indices
        valid = (g >= 0).to(torch.float32)[None].expand(self.b, self.hop)
        return valid, valid * (g[None, :] < end_frame[:, None]).to(torch.float32)

    def _encode(self, state: dict, chunk: torch.Tensor, valid: torch.Tensor):
        """Frame the encoder tail + chunk on the offline frame grid -> (tail +
        chunk [B, lag + c], codes [B, hop, N], aux)."""
        x = torch.cat([state["enc_tail"], chunk], dim=-1)
        codes, aux = self.model.front.encode(x)
        return x, codes * valid[..., None], aux

    def _features_and_norm(self, state: dict, codes: torch.Tensor, valid: torch.Tensor):
        """Causal smoothing over the carried codes, then the cumulative norm
        (Welford's with ``long_stream``) -> (smoothing tail + codes, normed
        [B, hop, N], norm carry)."""
        cat = torch.cat([state["smooth_tail"], codes], dim=1)
        feats = self.model.front.features(cat)[:, cat.shape[1] - self.hop:]
        norm = cumulative_norm_welford if self.long_stream else cumulative_norm
        normed, carry = norm(feats, valid, carry=state["norm_carry"])
        return cat, normed, carry

    def _trunk(self, state: dict, normed: torch.Tensor, valid: torch.Tensor):
        """The causal TCN over the new frames -> (h, new conv state)."""
        model = self.model
        return tcn_stack_streaming(model.tcn, normed, state["dw"], mask=valid,
                                   blocks_per_repeat=model.cfg.sep.blocks,
                                   compute_dtype=model.compute_dtype)

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        """The sigmoid mask head -> [B, hop, N, S]."""
        model = self.model
        return torch.sigmoid(dense(model.proj_mask, h, model.compute_dtype)).reshape(
            self.b, self.hop, model.cfg.front.feature_dim, self.n_spk)

    def _decode(self, state: dict, codes, aux, m, dec_valid):
        """Decode + streaming overlap-add -> (block [B, S, c], new OLA tail)."""
        c_samp, lag = self.c, self.lag
        y = self.model.apply_masks_and_decode(codes * dec_valid[..., None], aux, m,
                                              c_samp + lag)  # [B, S, c + lag]
        est = y[..., :c_samp].clone()
        est[..., :lag] += state["ola_tail"]
        return est, y[..., c_samp:]

    @torch.no_grad()
    def step(self, state: dict, chunk: torch.Tensor, end_frame: torch.Tensor
             ) -> tuple[torch.Tensor, dict]:
        """One push as a pure function: (state, chunk [B, c], end_frame [B]
        int64), all on the device -> (block [B, S, c], the next state).  It
        changes neither ``state`` nor the separator."""
        valid, dec_valid = self._masks(state, end_frame)
        x, codes, aux = self._encode(state, chunk, valid)
        cat, normed, carry = self._features_and_norm(state, codes, valid)
        h, dw = self._trunk(state, normed, valid)
        est, ola_tail = self._decode(state, codes, aux, self._head(h), dec_valid)
        return est, {"enc_tail": x[:, self.c:], "smooth_tail": cat[:, self.hop:],
                     "norm_carry": carry, "dw": dw, "ola_tail": ola_tail,
                     "frame_base": state["frame_base"] + self.hop}

    def _step(self, chunk: torch.Tensor, end_frame: torch.Tensor) -> torch.Tensor:
        """``step`` on the separator's own state, which it advances."""
        est, self._state = self.step(self._state, chunk, end_frame)
        return est

    # ----------------------------------------------------------------- host
    def _end_frames(self, end_frame) -> torch.Tensor:
        """The per-stream end frames on the device, copied once per value."""
        ends = np.array(np.broadcast_to(np.asarray(
            _NO_END if end_frame is None else end_frame, np.int64), (self.b,)))
        if self._end is None or not np.array_equal(self._end[0], ends):
            self._end = (ends, self._to_device(ends))
        return self._end[1]

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device without waiting: through pinned memory, whose
        block the caching allocator keeps until the copy is done."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _dispatch(self, chunk: np.ndarray, end_frame) -> torch.Tensor:
        """Queue one push on the device; returns its block [B, S, c] there."""
        if self.b == 1 and chunk.shape == (self.c,):
            chunk = chunk[None]
        if chunk.shape != (self.b, self.c):
            raise ValueError(
                f"push expects a ({self.b}, {self.c}) chunk batch "
                f"(or ({self.c},) when n_streams=1), got {chunk.shape}")
        ends = self._end_frames(end_frame)
        return self._step(self._to_device(chunk.astype(np.float32, copy=False)), ends)

    def _book(self, dt: float) -> None:
        if not self._warm:
            self.warmup_seconds += dt
            self._warm = True
        else:
            self.compute_seconds += dt
            self._timed_pushes += 1

    def push(self, chunk: np.ndarray, end_frame=None) -> np.ndarray:
        """chunk [B, c] (or [c] when n_streams == 1) mixture samples ->
        [B, S, c] ([S, c]) separated samples; the output lags the input by
        filter_len - stride samples.

        end_frame: each finite utterance's frame count, when known (an int or
        [B]); zero-padded tail frames past it are left out of the decode, so
        the last samples equal the offline ones (``separate_stream`` passes
        it; open streams leave it None)."""
        squeeze = self.b == 1 and chunk.ndim == 1
        t0 = time.perf_counter()
        out = self._dispatch(chunk, end_frame).cpu().numpy()  # the fetch waits
        self._book(time.perf_counter() - t0)
        return out[0] if squeeze else out

    def _fetch_async(self, est: torch.Tensor):
        """Start the copy of ``est`` to pinned host memory; -> (host, event)."""
        if self.device.type != "cuda":
            return est.cpu(), None
        host = torch.empty(est.shape, dtype=est.dtype, pin_memory=True)
        host.copy_(est, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _take_pending(self) -> np.ndarray | None:
        if self._pending is None:
            return None
        host, done = self._pending
        self._pending = None
        if done is not None:
            done.synchronize()  # this block's copy only, not the pushes queued after it
        out = host.numpy()
        return out[0] if self.b == 1 else out

    def push_async(self, chunk: np.ndarray, end_frame=None) -> np.ndarray | None:
        """Queue a push without waiting for it; returns the previous push's
        block (None on the first call), so push k+1 runs on the device while
        block k comes back.  ``flush()`` returns the last block."""
        t0 = time.perf_counter()
        est = self._dispatch(chunk, end_frame)
        out = self._take_pending()
        self._pending = self._fetch_async(est)
        self._book(time.perf_counter() - t0)
        return out

    def flush(self) -> np.ndarray | None:
        """The last ``push_async`` block."""
        t0 = time.perf_counter()
        out = self._take_pending()
        if out is not None:
            self.compute_seconds += time.perf_counter() - t0
        return out

    def _plan(self, t: int) -> tuple[int, int]:
        return -(-(t + self.lag) // self.c), self.model.cfg.front.frames_for(t)

    def _padded(self, waves: np.ndarray) -> tuple[np.ndarray, int, int]:
        t = waves.shape[-1]
        n_chunks, nf = self._plan(t)
        padded = np.zeros((*waves.shape[:-1], n_chunks * self.c), np.float32)
        padded[..., :t] = waves
        return padded, n_chunks, nf

    def separate_stream(self, wave: np.ndarray) -> np.ndarray:
        """One utterance (n_streams == 1) through ``push`` -> [S, len(wave)],
        ``model.separate``'s output.  Resets the stream state first."""
        if self.b != 1:
            raise ValueError("separate_stream serves one stream; use "
                             "separate_streams for n_streams > 1")
        self.reset()
        t = len(wave)
        padded, n_chunks, nf = self._padded(np.asarray(wave))
        outs = [self.push(padded[i * self.c : (i + 1) * self.c], end_frame=nf)
                for i in range(n_chunks)]
        return np.concatenate(outs, axis=-1)[:, self.lag : self.lag + t]

    def separate_stream_pipelined(self, wave: np.ndarray) -> np.ndarray:
        """``separate_stream`` through ``push_async``/``flush``: the same
        output, one more chunk of latency."""
        if self.b != 1:
            raise ValueError("separate_stream_pipelined serves one stream")
        self.reset()
        t = len(wave)
        padded, n_chunks, nf = self._padded(np.asarray(wave))
        outs = [self.push_async(padded[i * self.c : (i + 1) * self.c], end_frame=nf)
                for i in range(n_chunks)]
        outs = [o for o in outs if o is not None] + [self.flush()]
        return np.concatenate(outs, axis=-1)[:, self.lag : self.lag + t]

    def separate_streams(self, waves: np.ndarray, lengths=None) -> np.ndarray:
        """B utterances at once: waves [B, T] -> [B, S, T], every stream
        advancing one chunk per push.  ``lengths`` [B] gives ragged streams
        their own end frames (each row zero-padded past its length)."""
        if waves.shape[0] != self.b:
            raise ValueError(
                f"separate_streams expects [{self.b}, T] waves "
                f"(n_streams={self.b}), got {waves.shape}")
        self.reset()
        t = waves.shape[-1]
        padded, n_chunks, nf = self._padded(np.asarray(waves))
        if lengths is not None:
            nf = [self.model.cfg.front.frames_for(n) for n in lengths]
        outs = [self.push(padded[:, i * self.c : (i + 1) * self.c], end_frame=nf)
                for i in range(n_chunks)]
        return np.concatenate(outs, axis=-1)[:, :, self.lag : self.lag + t]

    @property
    def rtf(self) -> float:
        """Real-time factor over everything pushed after the first push, across
        all streams: wall time of the pushes (upload, compute, fetch) over the
        audio time (B streams x c samples per push)."""
        audio_s = self._timed_pushes * self.b * self.c / self.sample_rate
        return self.compute_seconds / audio_s if audio_s else float("inf")
