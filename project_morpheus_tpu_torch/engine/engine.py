"""Continuous-batching serving engine over a device-resident slot table
(port of engine/engine.py).

- A fixed **slot table** lives on the device: the KV cache, per-slot
  lengths, activity, budgets, sampling parameters, token-presence masks and,
  in audio mode, the per-slot code ring.  Torch updates it in place.
- **Admission** turns every prompt into a chunked-prefill job whose chunk
  plan is frozen at admission; at most one chunk runs between decode
  frames, and the final chunk samples the first token.
- **Decode** advances every active slot by ``steps_per_sync`` tokens per
  dispatch, sampling per slot (temperature / top-p / repetition penalty)
  with each slot's own generator.  Int8 caches at context buckets of
  ``pallas_min_bucket`` and above attend through the CUDA slot kernel.
- **Audio mode** pushes sampled codes into the device ring and, for every
  lane that completed a codec frame, runs one batched streaming SNAC hop
  with per-lane commit masks; the host ``StreamPlanner`` mirrors the
  schedule so end-of-stream flush hops know their window.
- **Eviction** (stop token, budget, cancel/barge-in) clears the slot;
  co-batched requests are untouched.

The host loop is one asyncio task; per-request streams are asyncio queues.
Each dispatch reads its tokens back before the next one starts (the JAX
engine's readback overlap and multi-frame dispatch are not ported).
"""
from __future__ import annotations

import asyncio
import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..codec.stream_decode import EMIT_SLOT, WINDOW_FRAMES, snac_stream_body
from ..model.config import LlamaConfig, ORPHEUS_SPECIAL_TOKENS
from ..model.llama import init_kv_cache, llama_decode_step, llama_prefill_chunk
from ..model.quant import fuse_layer_weights, is_quantized
from ..model.sampling import SamplingParams, sample_logits
from ..utils.device import resolve_device
from .request import Request, RequestState

_AUDIO_BASE = ORPHEUS_SPECIAL_TOKENS["audio_base"]
_CODEBOOK = 4096
_FRAME_TOKENS = 7
# per-slot custom stop ids live in a (B, _MAX_CUSTOM_STOPS) device array;
# further ids are enforced on the host only
_MAX_CUSTOM_STOPS = 8

logger = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 8
    max_seq_len: int = 2048
    prefill_buckets: Tuple[int, ...] = (32, 64, 128, 256, 512, 1024)
    # prompts longer than the largest prefill bucket are written in chunks
    # of this size, each attending to the cache history
    prefill_chunk: int = 1024
    # chunks halve once the attended history passes this depth, when some
    # stream is already decoding at admission (see _plan_chunks)
    fine_chunk_hist: int = 4096
    # decode context buckets: dense attention reads only the bucket prefix
    context_buckets: Tuple[int, ...] = (256, 512, 1024, 2048, 4096, 8192)
    cache_dtype: str = "bfloat16"
    # "auto": on the card, int8 caches at buckets >= pallas_min_bucket use
    # the CUDA slot kernel, everything else the dense bucketed attention;
    # "kernel" / "dense" force one path (the JAX package names the kernel
    # path "pallas")
    attn_impl: str = "auto"
    # smallest context bucket at which "auto" selects the kernel (the
    # field keeps the JAX package's name)
    pallas_min_bucket: int = 2048
    # int8 activations in the chunk-prefill projections/MLP (quantized
    # weights only)
    prefill_w8a8: bool = True
    steps_per_sync: int = 0  # 0/auto -> 7 on the card (one SNAC frame), 1 elsewhere
    # codec frames per dispatch: the port runs one (0 and 1 mean it);
    # larger values raise until multi-frame dispatch is ported
    frames_per_dispatch: int = 0
    # backpressure: a slot whose consumer queue is this deep is gated out
    # of decode dispatches until the consumer drains
    max_queued_hops: int = 24
    max_queued_tokens: int = 512
    # band-agnostic token->code mapping, for random-weight benches
    lenient_audio_codes: bool = False
    # constrain each audio lane's sampling to its current position's
    # 4096-id band, so random weights emit banded traces
    banded_sampling: bool = False
    default_stop_ids: Tuple[int, ...] = (
        ORPHEUS_SPECIAL_TOKENS["end_of_speech"],
        ORPHEUS_SPECIAL_TOKENS["end_of_text"],
    )


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _band_mask_logits(logits, is_audio, audio_pos):
    """Mask (B, Vp) logits to each audio lane's current 4096-id band
    (band = audio_pos % 7); text lanes pass through."""
    lane = torch.arange(logits.shape[1], device=logits.device)[None, :]
    lo = _AUDIO_BASE + (audio_pos % _FRAME_TOKENS) * _CODEBOOK
    in_band = (lane >= lo[:, None]) & (lane < (lo + _CODEBOOK)[:, None])
    keep = torch.where(is_audio[:, None], in_band, torch.ones_like(in_band))
    return torch.where(keep, logits, torch.full_like(logits, -torch.inf))


def _audio_code(toks, audio_pos, lenient: bool):
    """(valid, code) for one step's sampled tokens (B,), device side."""
    off = toks - _AUDIO_BASE
    if lenient:
        valid = (off >= 0) & (off < _FRAME_TOKENS * _CODEBOOK)
        code = off % _CODEBOOK
    else:
        code = off - (audio_pos % _FRAME_TOKENS) * _CODEBOOK
        valid = (code >= 0) & (code < _CODEBOOK)
    valid = valid & (toks >= 0)
    return valid, torch.where(valid, code, torch.zeros_like(code))


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class OrpheusEngine:
    """Async continuous-batching engine producing per-request streams."""

    def __init__(
        self,
        params,
        model_cfg: LlamaConfig,
        engine_cfg: Optional[EngineConfig] = None,
        *,
        codec: Optional[tuple] = None,  # (snac_params, SNACConfig): audio mode
        seed: int = 0,
        device="cuda",
    ) -> None:
        self.ecfg = engine_cfg or EngineConfig()
        if self.ecfg.frames_per_dispatch > 1:
            raise ValueError(
                f"frames_per_dispatch={self.ecfg.frames_per_dispatch}: multi-frame dispatch "
                "is not ported; the engine runs one codec frame per dispatch (use 0 or 1)")
        self.device = resolve_device(device)
        # serving-time projection fusion (wqkv / wgu), numerically identical
        self.params = fuse_layer_weights(_tree_to(params, self.device))
        self.cfg = model_cfg
        self._codec = None
        if codec is not None:
            self._codec = (_tree_to(codec[0], self.device), codec[1])
        self._w8a8 = bool(self.ecfg.prefill_w8a8) and any(
            is_quantized(w) for w in self.params["layers"].values())
        B, Vp, dev = self.ecfg.max_slots, model_cfg.padded_vocab, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        self.cache = init_kv_cache(model_cfg, B, self.ecfg.max_seq_len,
                                   _DTYPES[self.ecfg.cache_dtype], dev)
        self.lengths = torch.zeros(B, **i32)
        self.active = torch.zeros(B, dtype=torch.bool, device=dev)
        self.remaining = torch.zeros(B, **i32)
        self.is_audio = torch.zeros(B, dtype=torch.bool, device=dev)
        self.custom_stops = torch.full((B, _MAX_CUSTOM_STOPS), -1, **i32)
        self.last_tokens = torch.zeros(B, **i32)
        self.presence = torch.zeros((B, Vp), dtype=torch.bool, device=dev)
        self.temp = torch.zeros(B, dtype=torch.float32, device=dev)
        self.top_p = torch.ones(B, dtype=torch.float32, device=dev)
        self.rep_pen = torch.ones(B, dtype=torch.float32, device=dev)
        # per-slot sampling generators, reseeded at every admission
        self._gens = [torch.Generator(device=dev) for _ in range(B)]
        self._temp_host = [0.0] * B
        self._seed_gen = torch.Generator().manual_seed(seed)
        self._snac_state = None
        if self._codec is not None:
            from ..codec.stream_decode import init_stream_state

            self.ring = torch.zeros((B, WINDOW_FRAMES * _FRAME_TOKENS), **i32)
            self.partial = torch.zeros((B, _FRAME_TOKENS), **i32)
            self.pcnt = torch.zeros(B, **i32)
            self.fcnt = torch.zeros(B, **i32)
            self.audio_pos = torch.zeros(B, **i32)
            self.frame_done = torch.zeros(B, dtype=torch.bool, device=dev)
            self._snac_state = init_stream_state(self._codec[1], B, dev)
        self.attn_impl = self.ecfg.attn_impl
        self.steps_per_sync = self.ecfg.steps_per_sync
        if self.steps_per_sync <= 0:
            self.steps_per_sync = 7 if self.device.type == "cuda" else 1
        self._free: List[int] = list(range(B))
        self._by_slot: Dict[int, Request] = {}
        self._prefill_jobs: List[dict] = []
        self._pending_lane_resets: set = set()
        self._pending: "asyncio.Queue[Request]" = asyncio.Queue()
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._closed = False
        self.steps = 0

    # ------------------------------------------------------------------ api

    @property
    def supports_audio(self) -> bool:
        return self._codec is not None

    async def submit(self, prompt_ids: Sequence[int],
                     sampling: Optional[SamplingParams] = None, *,
                     audio: bool = False) -> Request:
        req = Request(list(prompt_ids), (sampling or SamplingParams()).clipped())
        req.on_drain = self._wake.set
        if audio:
            if not self.supports_audio:
                raise ValueError("engine built without a codec; audio mode off")
            from ..codec.stream_decode import StreamPlanner

            req.audio = True
            req.planner = StreamPlanner()
        await self._pending.put(req)
        self._wake.set()
        self._ensure_running()
        return req

    def cancel(self, req: Request) -> None:
        """Barge-in / client-drop path: immediate slot eviction."""
        if req.done:
            return
        req.state = RequestState.CANCELLED
        if req.slot is not None:
            self._evict(req.slot)
        req.token_queue.put_nowait(None)
        if req.audio:
            req.pcm_queue.put_nowait(None)
        self._wake.set()

    async def close(self) -> None:
        self._closed = True
        self._wake.set()
        if self._task is not None:
            await self._task

    # ------------------------------------------------------------ internals

    def _ensure_running(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_event_loop().create_task(self._run())

    def _guarded_admit(self, req: Request) -> None:
        """An admission failure fails that request, not the engine task."""
        try:
            self._admit(req)
        except Exception:
            logger.exception("admission failed for request %s; failing it and "
                             "continuing to serve", req.request_id)
            if req.slot is not None:
                self._evict(req.slot)
            req.state = RequestState.CANCELLED
            req.token_queue.put_nowait(None)
            if req.audio:
                req.pcm_queue.put_nowait(None)

    def _evict(self, slot: int) -> None:
        """Free one slot's device state; other slots are untouched."""
        self.active[slot] = False
        self.lengths[slot] = 0
        self.remaining[slot] = 0
        self.is_audio[slot] = False
        self.custom_stops[slot] = -1
        self.presence[slot] = False
        if self._codec is not None:
            for t in (self.ring, self.partial, self.pcnt, self.fcnt, self.audio_pos):
                t[slot] = 0
            self.frame_done[slot] = False
        self._by_slot.pop(slot, None)
        if slot not in self._free:
            self._free.append(slot)

    def _admit(self, req: Request) -> None:
        # the seed fixes the slot's whole sampling chain
        if req.sampling.seed is not None:
            seed = int(req.sampling.seed) & 0xFFFFFFFF
        else:
            seed = int(torch.randint(0, 2**62, (1,), generator=self._seed_gen))
        slot = self._free.pop()
        req.slot = slot
        req.state = RequestState.PREFILLING
        self._by_slot[slot] = req
        if req.audio:
            self._pending_lane_resets.add(slot)  # fresh codec lane
        ids = req.prompt_ids
        margin = 2
        max_prompt = self.ecfg.max_seq_len - margin - 2
        if len(ids) > max_prompt:
            logger.warning("prompt of %d tokens exceeds context window; keeping "
                           "the last %d", len(ids), max_prompt)
            ids = ids[-max_prompt:]
        req.ctx_len = len(ids)
        # total generation budget, enforced on the device (_post_step) and
        # on the host (_deliver) in lockstep
        req.allowed = min(req.sampling.max_tokens,
                          self.ecfg.max_seq_len - margin - req.ctx_len)
        custom = [s for s in dict.fromkeys(req.sampling.stop_token_ids)
                  if s not in self.ecfg.default_stop_ids]
        if len(custom) > _MAX_CUSTOM_STOPS:
            logger.warning("request has %d custom stop ids; device-side early stop "
                           "covers the first %d", len(custom), _MAX_CUSTOM_STOPS)
            custom = custom[:_MAX_CUSTOM_STOPS]
        stops = np.full((_MAX_CUSTOM_STOPS,), -1, np.int32)
        stops[: len(custom)] = custom
        # chunk plan frozen at admission: fine rounds only when some stream
        # is already decoding
        fine = any(r.state is RequestState.DECODING for r in self._by_slot.values())
        self._prefill_jobs.append({"req": req, "slot": slot, "ids": list(ids),
                                   "offset": 0, "stops": stops, "seed": seed,
                                   "fine": fine})

    def _hist_bucket(self, need: int) -> int:
        """Smallest history bucket covering ``need`` positions."""
        for b in sorted(self.ecfg.context_buckets):
            if need <= b <= self.ecfg.max_seq_len:
                return b
        return self.ecfg.max_seq_len

    def _plan_chunks(self, total: int, fine: bool = True) -> List[tuple]:
        """Chunk schedule of a prompt: [(offset, chunk_len, hist, final)].
        With ``fine``, chunks halve once the history passes
        ``fine_chunk_hist``; a cold admission keeps full-width chunks."""
        top = max(self.ecfg.prefill_buckets)
        out: List[tuple] = []
        off = 0
        while total - off > top:
            c = self.ecfg.prefill_chunk
            if fine and off >= self.ecfg.fine_chunk_hist:
                c = max(min(self.ecfg.prefill_buckets), c // 2)
            c = min(c, total - off - 1)  # final chunk is never empty
            out.append((off, c, self._hist_bucket(off + c), False))
            off += c
        rb = _bucket_for(total - off, self.ecfg.prefill_buckets)
        out.append((off, rb, self._hist_bucket(off + rb), True))
        return out

    def _job_next(self, job) -> tuple:
        """The job's next chunk: (final, chunk_len, hist)."""
        for off, clen, hist, final in self._plan_chunks(len(job["ids"]), job["fine"]):
            if off == job["offset"]:
                return final, clen, hist
        raise AssertionError(f"offset {job['offset']} not on the chunk plan")

    def _advance_prefill(self) -> None:
        """Run at most ONE prefill chunk (of the oldest live job); a final
        chunk samples and routes the first token."""
        if self._pending_lane_resets:
            from ..codec.stream_decode import reset_lanes

            mask = torch.zeros(self.ecfg.max_slots, dtype=torch.bool)
            mask[sorted(self._pending_lane_resets)] = True
            self._pending_lane_resets.clear()
            reset_lanes(self._snac_state, mask.to(self.device))
        self._prefill_jobs = [
            j for j in self._prefill_jobs
            if not j["req"].done and self._by_slot.get(j["slot"]) is j["req"]
        ]
        if not self._prefill_jobs:
            return
        job = self._prefill_jobs[0]
        final, clen, hist = self._job_next(job)
        req, slot, offset = job["req"], job["slot"], job["offset"]
        part = job["ids"][offset: offset + clen]
        padded = torch.zeros(clen, dtype=torch.int32)
        padded[: len(part)] = torch.as_tensor(part, dtype=torch.int32)
        padded = padded.to(self.device)
        logits = llama_prefill_chunk(
            self.params, padded, self.cfg, self.cache, offset, slot, len(part),
            hist_bucket=hist, w8a8=self._w8a8)
        # this chunk's real tokens count as seen for the repetition penalty
        self.presence[slot, padded[: len(part)].long()] = True
        if not final:
            job["offset"] += clen
            return
        self._prefill_jobs.pop(0)
        first = self._sample_first(job, logits, offset + len(part))
        req.state = RequestState.DECODING
        self._route_batch([(slot, req, first)], {slot: req})

    def _sample_first(self, job, logits, ctx_len: int) -> int:
        """Sample the first token from the prompt's last logits and seed the
        slot's serving state."""
        req, slot = job["req"], job["slot"]
        sp = req.sampling
        dev = self.device
        gen = self._gens[slot]
        gen.manual_seed(job["seed"])
        self._temp_host[slot] = float(sp.temperature)
        if self.ecfg.banded_sampling:  # first audio code samples from band 0
            logits = _band_mask_logits(
                logits[None], torch.tensor([req.audio], device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev))[0]
        f32 = dict(dtype=torch.float32, device=dev)
        first = int(sample_logits(
            logits[None],
            [gen if sp.temperature > 0 else None],
            temperature=torch.tensor([sp.temperature], **f32),
            top_p=torch.tensor([sp.top_p], **f32),
            repetition_penalty=torch.tensor([sp.repetition_penalty], **f32),
            presence=self.presence[slot][None],
            vocab_size=self.cfg.vocab_size,
        )[0])
        self.presence[slot, first] = True
        self.lengths[slot] = ctx_len
        self.last_tokens[slot] = first
        self.temp[slot] = sp.temperature
        self.top_p[slot] = sp.top_p
        self.rep_pen[slot] = sp.repetition_penalty
        self.active[slot] = req.allowed > 1
        self.remaining[slot] = req.allowed - 1
        self.is_audio[slot] = req.audio
        self.custom_stops[slot] = torch.as_tensor(job["stops"], device=dev)
        if self._codec is not None and req.audio:
            # the first code enters the device ring as a decode step's would
            code = self._host_code(first, 0)
            if code is not None:
                self.partial[slot, 0] = code
                self.pcnt[slot] += 1
                self.audio_pos[slot] += 1
        return first

    def _host_code(self, token: int, audio_pos: int) -> Optional[int]:
        from ..adapters.runtime import audio_code_from_token_id, lenient_audio_code

        if self.ecfg.lenient_audio_codes:
            return lenient_audio_code(token)
        return audio_code_from_token_id(token, audio_pos)

    def _deliver(self, req: Request, token: int) -> None:
        """Route one sampled token to the request, handling stop conditions."""
        stop_ids = req.stop_set
        if stop_ids is None:
            stop_ids = req.stop_set = (set(req.sampling.stop_token_ids)
                                       | set(self.ecfg.default_stop_ids))
        req.generated += 1
        hit_stop = token in stop_ids
        out_of_budget = req.generated >= req.allowed
        if not hit_stop:
            req.token_queue.put_nowait(token)
        if hit_stop or out_of_budget:
            req.state = RequestState.FINISHED
            if req.slot is not None:
                self._evict(req.slot)
            req.token_queue.put_nowait(None)

    def _context_bucket(self, n_steps: int) -> Optional[int]:
        """Smallest bucket covering every live context through this dispatch."""
        if not self._by_slot:
            return None
        # the same headroom as the JAX engine (which also covers one frame
        # still in flight), so both pick the same bucket
        need = (max(r.ctx_len + r.generated for r in self._by_slot.values())
                + n_steps + self.steps_per_sync + 2)
        need = min(need, self.ecfg.max_seq_len)
        for b in sorted(self.ecfg.context_buckets):
            if need <= b <= self.ecfg.max_seq_len:
                return b
        return None  # full allocated context

    def _backpressure_gate(self) -> Optional[torch.Tensor]:
        """(B,) bool gate from consumer-queue depth, or None when no live
        slot can take a frame."""
        gate = np.ones((self.ecfg.max_slots,), bool)
        any_ready = False
        for slot, req in self._by_slot.items():
            depth = req.pcm_queue.qsize() if req.audio else req.token_queue.qsize()
            limit = self.ecfg.max_queued_hops if req.audio else self.ecfg.max_queued_tokens
            if depth >= limit:
                gate[slot] = False
            elif req.state is RequestState.DECODING:
                any_ready = True
        if not any_ready:
            return None
        return torch.as_tensor(gate, device=self.device)

    def _attn_for(self, bucket: Optional[int]) -> str:
        """Resolve attn_impl="auto": on the card, int8 caches at long
        context take the slot kernel (its bytes follow each slot's live
        length); everything else the dense bucketed attention."""
        if self.attn_impl != "auto":
            return self.attn_impl
        if (self.device.type == "cuda"
                and self.ecfg.cache_dtype == "int8"
                and (bucket or self.ecfg.max_seq_len) >= self.ecfg.pallas_min_bucket):
            return "kernel"
        return "dense"

    # ----------------------------------------------------------- the step

    def _decode_core(self, gate, attn_impl: str, bucket, banded: bool):
        """One decode + sample step over the slot table; returns (B,) tokens,
        -1 on lanes that did not emit.  Each lane's generator advances only
        on steps where the lane emits."""
        active = self.active & gate
        logits = llama_decode_step(self.params, self.last_tokens, self.cfg, self.cache,
                                   self.lengths, active=active, attn_impl=attn_impl,
                                   bucket=bucket)
        if banded:
            logits = _band_mask_logits(logits, self.is_audio, self.audio_pos)
        act = active.tolist()
        gens = [g if a and t > 0 else None
                for g, a, t in zip(self._gens, act, self._temp_host)]
        toks = sample_logits(logits, gens, temperature=self.temp, top_p=self.top_p,
                             repetition_penalty=self.rep_pen, presence=self.presence,
                             vocab_size=self.cfg.vocab_size)
        toks = torch.where(active, toks, torch.zeros_like(toks))
        rows = torch.arange(toks.shape[0], device=self.device)
        seen = self.presence[rows, toks.long()]
        self.presence[rows, toks.long()] = seen | active
        self.lengths += active.to(torch.int32)
        self.last_tokens = torch.where(active, toks, self.last_tokens)
        return torch.where(active, toks, torch.full_like(toks, -1))

    def _post_step(self, toks, stop_ids: Tuple[int, ...]) -> None:
        """A lane stops on a default or custom stop id or an exhausted budget."""
        emitted = toks >= 0
        is_stop = emitted & (toks[:, None] == self.custom_stops).any(dim=1)
        for s in stop_ids:
            is_stop = is_stop | (toks == s)
        self.remaining -= emitted.to(torch.int32)
        self.active = self.active & ~is_stop & (self.remaining > 0)

    def _ring_push(self, toks, lenient: bool) -> None:
        """Append one step's codes to the per-slot device code ring; at most
        one frame completes per slot per dispatch."""
        valid, code = _audio_code(toks, self.audio_pos, lenient)
        valid = valid & self.is_audio  # text lanes never enter the ring
        sel = torch.arange(_FRAME_TOKENS, device=self.device)[None, :] == self.pcnt[:, None]
        partial = torch.where(valid[:, None] & sel, code[:, None], self.partial)
        pcnt2 = self.pcnt + valid.to(torch.int32)
        done = pcnt2 >= _FRAME_TOKENS
        self.ring = torch.where(
            done[:, None], torch.cat([self.ring[:, _FRAME_TOKENS:], partial], dim=1), self.ring)
        self.partial = torch.where(done[:, None], torch.zeros_like(partial), partial)
        self.pcnt = torch.where(done, torch.zeros_like(pcnt2), pcnt2)
        self.fcnt = self.fcnt + done.to(torch.int32)
        self.audio_pos = self.audio_pos + valid.to(torch.int32)
        self.frame_done = self.frame_done | done

    @torch.no_grad()
    def _dispatch_frame(self, gate):
        """Advance all ungated slots by ``steps_per_sync`` tokens; in audio
        mode also run the frame's batched SNAC hop.  Returns host arrays
        (toks (n, B), pcm (B, frame_samples) or None, emit (B,) or None)."""
        n = self.steps_per_sync
        stop_ids = tuple(sorted(self.ecfg.default_stop_ids))
        audio = self._codec is not None and any(r.audio for r in self._by_slot.values())
        bucket = self._context_bucket(n)
        attn = self._attn_for(bucket)
        lenient = self.ecfg.lenient_audio_codes
        if audio:
            self.frame_done = torch.zeros_like(self.frame_done)
        rows = []
        for _ in range(n):
            toks = self._decode_core(gate, attn, bucket, audio and self.ecfg.banded_sampling)
            self._post_step(toks, stop_ids)
            if audio:
                self._ring_push(toks, lenient)
            rows.append(toks)
        toks_host = torch.stack(rows).cpu().numpy()
        if not audio:
            return toks_host, None, None
        snac_params, snac_cfg = self._codec
        head = self.frame_done & (self.fcnt == 1)
        steady = self.frame_done & (self.fcnt >= WINDOW_FRAMES)
        emit = head | steady
        emit_host = emit.cpu().numpy()
        if not emit_host.any():
            return toks_host, None, emit_host
        B, fs = self.ecfg.max_slots, snac_cfg.frame_samples
        newest = self.ring[:, -_FRAME_TOKENS:]
        window = torch.where(head[:, None], newest.repeat(1, WINDOW_FRAMES), self.ring)
        pcm_win, self._snac_state = snac_stream_body(
            snac_params, window, self._snac_state, steady, cfg=snac_cfg)
        ws = torch.where(head, 0, EMIT_SLOT)
        pcm = pcm_win.reshape(B, WINDOW_FRAMES, fs)[torch.arange(B, device=self.device), ws]
        return toks_host, pcm.cpu().numpy(), emit_host

    # --------------------------------------------------------- routing

    def _route_token(self, slot: int, req: Request, token: int,
                     pending_hops: List[tuple], finished_audio: List[Request]) -> bool:
        """Deliver one token and mirror its audio framing on the host
        planner; True when the planner produced a head/steady hop."""
        pushed = False
        self._deliver(req, token)
        if req.audio:
            code = self._host_code(token, req.audio_pos)
            if code is not None:
                req.audio_pos += 1
                pushed = bool(req.planner.push(code))
            if req.done:
                for h in req.planner.flush():
                    pending_hops.append((slot, req, h))
                finished_audio.append(req)
        return pushed

    def _route_batch(self, items, slot_map) -> None:
        """Route (slot, req, token) items outside a frame (first tokens)."""
        pending_hops: List[tuple] = []
        finished_audio: List[Request] = []
        for slot, req, token in items:
            if req.done or self._by_slot.get(slot) is not req:
                continue
            self._route_token(slot, req, token, pending_hops, finished_audio)
        self._finish_audio(pending_hops, finished_audio)

    def _process_frame(self, toks_host, pcm_host, emit_host, slot_map) -> None:
        """Route one frame's tokens, then its PCM: a lane's hop reaches the
        consumer only when the host planner produced it from the routed
        tokens (a lane that stopped mid-dispatch emits nothing more)."""
        pending_hops: List[tuple] = []
        finished_audio: List[Request] = []
        host_hops: set = set()
        self.steps += toks_host.shape[0]
        for step_row in toks_host:
            for slot, req in slot_map.items():
                if req.state is not RequestState.DECODING or self._by_slot.get(slot) is not req:
                    continue
                token = int(step_row[slot])
                if token < 0:
                    continue
                if self._route_token(slot, req, token, pending_hops, finished_audio):
                    host_hops.add(slot)
        if pcm_host is not None:
            for slot, req in slot_map.items():
                if (req.audio and emit_host[slot] and slot in host_hops
                        and req.state is not RequestState.CANCELLED):
                    req.pcm_queue.put_nowait(pcm_host[slot].tobytes())
        self._finish_audio(pending_hops, finished_audio)

    def _finish_audio(self, pending_hops, finished_audio) -> None:
        if pending_hops:
            self._run_audio_hops(pending_hops)
        for req in finished_audio:
            req.pcm_queue.put_nowait(None)

    @torch.no_grad()
    def _run_audio_hops(self, pending: List[tuple]) -> None:
        """End-of-stream flush hops: all lanes' hops of one round in one
        batched call with per-lane commit masks."""
        snac_params, snac_cfg = self._codec
        B, fs = self.ecfg.max_slots, snac_cfg.frame_samples
        W = pending[0][2].window.shape[0]
        by_slot: Dict[int, List[tuple]] = {}
        for slot, req, h in pending:
            by_slot.setdefault(slot, []).append((req, h))
        for r in range(max(len(v) for v in by_slot.values())):
            windows = np.zeros((B, W), np.int32)
            commit = np.zeros((B,), bool)
            emits: List[tuple] = []
            for slot, lst in by_slot.items():
                if r >= len(lst):
                    continue
                req, h = lst[r]
                windows[slot] = h.window
                commit[slot] = h.commit
                emits.extend((slot, req, ws) for _f, ws in h.emits)
            pcm, self._snac_state = snac_stream_body(
                snac_params, torch.as_tensor(windows, device=self.device), self._snac_state,
                torch.as_tensor(commit, device=self.device), cfg=snac_cfg)
            pcm_np = pcm.cpu().numpy()
            for slot, req, ws in emits:
                if req.state is not RequestState.CANCELLED:
                    req.pcm_queue.put_nowait(pcm_np[slot, ws * fs:(ws + 1) * fs].tobytes())

    # ------------------------------------------------------------- loop

    async def _park(self) -> None:
        self._wake.clear()
        try:
            await asyncio.wait_for(self._wake.wait(), timeout=0.5)
        except asyncio.TimeoutError:
            pass

    async def _run(self) -> None:
        while not self._closed:
            # admission takes the whole backlog, up to the free slots
            if self._free and not self._pending.empty():
                deferred = []
                while not self._pending.empty():
                    req = self._pending.get_nowait()
                    if req.state is RequestState.CANCELLED:
                        continue
                    if self._free:
                        self._guarded_admit(req)
                    else:
                        deferred.append(req)
                for req in deferred:
                    self._pending.put_nowait(req)
            if not self._by_slot:
                if self._pending.empty():
                    await self._park()
                continue
            gate = self._backpressure_gate()
            if gate is None:
                if self._prefill_jobs:
                    # nothing decodable yet: keep admissions moving
                    self._advance_prefill()
                    await asyncio.sleep(0)
                    continue
                # every live consumer is saturated: park until one drains
                self._wake.clear()
                if (self._backpressure_gate() is not None
                        or not self._pending.empty() or self._closed):
                    continue
                await self._park()
                continue
            slot_map = dict(self._by_slot)
            toks, pcm, emit = self._dispatch_frame(gate)
            self._process_frame(toks, pcm, emit, slot_map)
            # at most one prefill chunk rides behind each frame
            self._advance_prefill()
            await asyncio.sleep(0)
