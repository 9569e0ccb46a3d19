"""Continuous-batching serving engine over a device-resident slot table
(port of engine/engine.py).

- A fixed **slot table** lives on the device: the KV cache, per-slot
  lengths, activity, budgets, sampling parameters and random streams,
  token-presence masks and, in audio mode, the per-slot code ring.  Every
  update is in place, so a captured frame program always reads the live
  storage.
- **Admission** turns every prompt into a chunked-prefill job whose chunk
  plan is frozen at admission.  At most one chunk round runs between
  decode frames; jobs in lockstep (a simultaneous burst) share one round
  at a power-of-two width.  Final chunks sample the first tokens on the
  device; they ride the next frame's readback.  Each round is a program
  keyed as JAX keys its jitted chunk programs (chunk width, history
  bucket, final, J, ...): on the card a CUDA graph that ``warmup``
  captures, its inputs staged into the key's static buffers; ``warmup``
  also caps the lockstep width at the widest J it ran.
- **Decode** is one fused frame program (``_frame_program``) of
  ``n_frames`` x ``steps_per_sync`` decode + sample + stop/budget + code
  ring steps and, in audio mode, one batched streaming SNAC hop per frame
  with per-lane commit masks; tokens, PCM and emit flags come back in one
  readback.  On the card each program is a CUDA graph captured on first
  use (``graphs.py``); ``warmup`` captures every program a workload can
  reach.  ``frames_per_dispatch`` frames go in one dispatch once no stream
  waits for admission or a first hop.
- **Readback overlap**: the loop dispatches frame N, enqueues the copy of
  its outputs into pinned host buffers, runs at most one prefill round,
  and only then routes frame N-1, whose copy a worker thread awaited.
  End-of-stream flush hops are routed in dispatch order without stalling.
- **Eviction** (stop token, budget, cancel/barge-in) clears the slot;
  co-batched requests are untouched.
- **Mesh** (``mesh=``, ``parallel.make_mesh``): one engine per rank, in
  lockstep, every rank given the same submits in the same order.  Under
  ``model`` > 1 the weights are the ``tp`` shards, unfused, and the cache
  holds the rank's own kv heads (and, int8, their scales); the model
  functions add the Megatron collectives (``parallel/tensor.py``: row-split
  partial sums all-reduced in fp32, vocab-split embedding and logits
  gathered before sampling).  Under ``data`` > 1 a rank's cache holds its
  block of slots and it decodes and prefills only those; the sampled
  tokens are all-gathered every step, so the small per-slot state (lengths,
  budgets, presence, the code ring, the codec state) and every host
  decision are the same on every rank.  Each loop turn starts with one
  host all-reduce that agrees the admissions, cancellations, backpressure
  gate and shutdown; everything after it is determined by tokens.  Frame
  programs are CUDA graphs over NCCL (captured collectives) and run
  eagerly over gloo, which cannot be captured; prefill rounds likewise,
  and they stay eager under ``data`` > 1, where the jobs a rank's cache
  holds change a round's shape.
- **Trace** (``start_trace()``, ``trace.py``): off by default; while on,
  request and loop spans, lane counts, and device stage stamps in every
  frame program captured meanwhile, all kept in memory.
"""
from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import contextlib
import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..codec.stream_decode import EMIT_SLOT, WINDOW_FRAMES, snac_stream_body
from ..model.config import LlamaConfig, ORPHEUS_SPECIAL_TOKENS
from ..model.llama import (
    decode_trunk_parts,
    init_kv_cache,
    llama_decode_step,
    llama_prefill_chunk_batch,
)
from ..model.quant import add_k_major_copies, fuse_layer_weights, is_quantized
from ..model.sampling import SamplingParams, sample_logits
from ..parallel.tensor import NO_TP, tensor_parallel
from ..utils.device import resolve_device
from .graphs import ProgramCache, StaticInputs
from .request import Request, RequestState
from .trace import EngineTrace, Stamps

_AUDIO_BASE = ORPHEUS_SPECIAL_TOKENS["audio_base"]
_CODEBOOK = 4096
_FRAME_TOKENS = 7
# per-slot custom stop ids live in a (B, _MAX_CUSTOM_STOPS) device array;
# further ids are enforced on the host only
_MAX_CUSTOM_STOPS = 8

logger = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8, "float32": torch.float32}
# a span site while the trace is off
_NO_SPAN = contextlib.nullcontext()


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
    # "auto": on one card (no mesh), bf16 caches at every bucket use the
    # CUDA layered flash-decode kernel, int8 caches at buckets >=
    # pallas_min_bucket the CUDA slot kernel (each raises for a (head_dim,
    # H // KV) it does not take); everything else the dense bucketed
    # attention.  "kernel" / "dense" force one path (the JAX package names
    # the kernel path "pallas")
    attn_impl: str = "auto"
    # smallest context bucket at which "auto" selects the kernel for an
    # int8 cache (the field keeps the JAX package's name)
    pallas_min_bucket: int = 2048
    # int8 activations in the chunk-prefill projections/MLP (quantized
    # weights only)
    prefill_w8a8: bool = True
    steps_per_sync: int = 0  # 0/auto -> 7 on the card (one SNAC frame), 1 elsewhere
    # most codec frames per audio dispatch (0/auto -> 1, the JAX default):
    # k frames go in one dispatch only while no prefill job or first token
    # is pending, no free slot has a queued request and every stream has
    # had its first hop; otherwise the dispatch runs one frame
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
        mesh=None,  # parallel.Mesh (data, model): TP/DP-sharded serving
        seed: int = 0,
        device="cuda",
    ) -> None:
        self.ecfg = engine_cfg or EngineConfig()
        self.device = resolve_device(device)
        self.mesh = mesh
        self.tp = NO_TP
        B = self.ecfg.max_slots
        self._slots = slice(0, B)  # the slots this rank's cache holds
        self._data = None          # data-axis group (slots split over it)
        self._ctrl = None          # host group of the lockstep agreement
        if mesh is not None:
            self._init_mesh(mesh)
        if mesh is not None and mesh.shape["model"] > 1:
            # Megatron splits q/k/v on head boundaries: a fused wqkv split
            # over `model` would cut mid-head, so TP keeps them separate
            from ..parallel.sharding import shard_params

            self.params = shard_params(_tree_to(params, self.device), mesh, "tp")
        else:
            # serving-time projection fusion (wqkv / wgu), numerically identical
            self.params = fuse_layer_weights(_tree_to(params, self.device))
        self.cfg = model_cfg
        self._codec = None
        if codec is not None:
            self._codec = (_tree_to(codec[0], self.device), codec[1])
        self._w8a8 = bool(self.ecfg.prefill_w8a8) and any(
            is_quantized(w) for w in self.params["layers"].values())
        if self._w8a8 and self.device.type == "cuda":
            # the w8a8 GEMM reads each weight K-major: a copy a rank, on the card
            self.params = add_k_major_copies(self.params)
        Vp, dev = model_cfg.padded_vocab, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        n_local = self._slots.stop - self._slots.start
        self.cache = init_kv_cache(self.tp.local_cfg(model_cfg), n_local, self.ecfg.max_seq_len,
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
        # per-slot random streams (model/sampling.py): set at admission;
        # a slot's draw counter advances on the steps where it emits
        self.seeds = torch.zeros(B, dtype=torch.int64, device=dev)
        self.draws = torch.zeros(B, dtype=torch.int64, device=dev)
        self._seed_gen = torch.Generator().manual_seed(seed)
        # static inputs of the frame programs: the backpressure gate
        self._gate_in = StaticInputs([((B,), torch.bool)], dev)
        self._gate = self._gate_in.bufs[0]
        self._gate.fill_(True)
        self._rows = torch.arange(B, device=dev)
        self._snac_state = None
        if self._codec is not None:
            from ..codec.stream_decode import init_stream_state

            self.ring = torch.zeros((B, WINDOW_FRAMES * _FRAME_TOKENS), **i32)
            self.partial = torch.zeros((B, _FRAME_TOKENS), **i32)
            self.pcnt = torch.zeros(B, **i32)
            self.fcnt = torch.zeros(B, **i32)
            self.audio_pos = torch.zeros(B, **i32)
            self.frame_done = torch.zeros(B, dtype=torch.bool, device=dev)
            self._frame_lanes = torch.arange(_FRAME_TOKENS, device=dev)
            self._snac_state = init_stream_state(self._codec[1], B, dev)
        self.attn_impl = self.ecfg.attn_impl
        self.steps_per_sync = self.ecfg.steps_per_sync
        if self.steps_per_sync <= 0:
            self.steps_per_sync = 7 if self.device.type == "cuda" else 1
        self.frames_per_dispatch = max(1, self.ecfg.frames_per_dispatch)
        self._stop_ids = tuple(sorted(self.ecfg.default_stop_ids))
        graphs = mesh is None or mesh.backend != "gloo"
        if not graphs:
            logger.info("mesh engine over gloo: frame programs run eagerly (gloo collectives "
                        "cannot be captured in CUDA graphs)")
        self.programs = ProgramCache(self.device, graphs=graphs)
        # prefill rounds as programs (graphs on the card): off runs them
        # eagerly, as a data split does
        self.prefill_graphs = True
        self._data_split = mesh is not None and mesh.shape["data"] > 1
        # static input buffers of each prefill program, by key
        self._prefill_inputs: Dict[tuple, StaticInputs] = {}
        # widest lockstep round warmup ran (0: uncapped, as before a warmup)
        self._max_batch_j = 0
        # slots whose cancellation waits for the next lockstep agreement
        self._cancel_slots: set = set()
        self._agreed_pending = 0
        self._free: List[int] = list(range(B))
        self._by_slot: Dict[int, Request] = {}
        self._prefill_jobs: List[dict] = []
        self._pending_lane_resets: set = set()
        # first tokens sampled by a prefill, still on the device:
        # (slot, req, (1,) device tensor), read back with the next frame
        self._pending_first: List[tuple] = []
        # end-of-stream flush hops in dispatch order: ("pcm", future,
        # [(slot, req, window_slot)]) or ("eos", req)
        self._pending_audio: List[tuple] = []
        # frame readbacks and flush-hop readbacks wait on their CUDA events
        # here, off the event loop
        self._readback_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="engine-readback")
        # two sets of pinned host buffers: two frames are in flight
        self._host_sets: List[Dict[tuple, torch.Tensor]] = [{}, {}]
        self._host_turn = 0
        self._pending: "asyncio.Queue[Request]" = asyncio.Queue()
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._closed = False
        self.steps = 0
        # prefill rounds run, by width J
        self.prefill_rounds: collections.Counter = collections.Counter()
        # the in-memory trace (trace.py), None while off
        self.trace: Optional[EngineTrace] = None

    def _init_mesh(self, mesh) -> None:
        import torch.distributed as dist

        if mesh.device.type != self.device.type:
            raise ValueError(f"mesh on {mesh.device}, engine asked for {self.device}")
        self.device = mesh.device
        self.tp = tensor_parallel(mesh)
        dp, B = mesh.shape["data"], self.ecfg.max_slots
        if B % dp:
            raise ValueError(f"max_slots={B} does not split over data={dp}")
        lo = mesh.coords["data"] * (B // dp)
        self._slots = slice(lo, lo + B // dp)
        self._data = mesh.group("data")
        if dist.is_initialized():
            # host decisions are agreed on the CPU: over gloo, a group of its
            # own when the default backend is NCCL (created on every rank)
            self._ctrl = dist.group.WORLD if mesh.backend == "gloo" else \
                dist.new_group(backend="gloo")

    # ------------------------------------------------------------------ api

    @property
    def supports_audio(self) -> bool:
        return self._codec is not None

    def start_trace(self) -> EngineTrace:
        """Turn the trace on (``trace.py``), or return the one that is on.
        Frame programs captured from now on take device stamps."""
        if self.trace is None:
            self.trace = EngineTrace(self.device)
        return self.trace

    def stop_trace(self) -> Optional[EngineTrace]:
        """Turn the trace off; returns what it recorded."""
        trace, self.trace = self.trace, None
        return trace

    def _span(self, name: str, device: bool = False):
        """The trace's span ``name`` around a block; nothing while it is off."""
        return _NO_SPAN if self.trace is None else self.trace.span(name, device)

    async def submit(self, prompt_ids: Sequence[int],
                     sampling: Optional[SamplingParams] = None, *,
                     audio: bool = False) -> Request:
        req = Request(list(prompt_ids), (sampling or SamplingParams()).clipped())
        req.on_drain = self._wake.set
        if self.trace is not None:
            self.trace.request_start(req)
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
        """Barge-in / client-drop path: immediate slot eviction (on a mesh, at
        the next lockstep agreement, on every rank)."""
        if req.done:
            return
        req.state = RequestState.CANCELLED
        if self.trace is not None:
            self.trace.request_end(req)
        if req.slot is not None:
            if self._ctrl is not None:
                self._cancel_slots.add(req.slot)
            else:
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
        self._readback_pool.shutdown(wait=False)

    @torch.no_grad()
    def warmup(self, prompt_lens: Sequence[int] = (), max_new_tokens: int = 0,
               burst: int = 1) -> int:
        """Build the CUDA kernels and run every serving program a workload
        of ``prompt_lens`` x ``max_new_tokens`` can reach: each prefill
        round once at the power-of-two widths J up to ``burst``, and each
        frame program of every context bucket a stream crosses, at k = 1
        and ``frames_per_dispatch`` (on the card, captured as CUDA graphs).
        Lockstep rounds are then capped at the widest J run, as in JAX, so
        a wider burst lands on a warmed program.

        Uses the chunk plan and bucket arithmetic of serving, runs on the
        idle slot table with every lane inactive and releases every slot
        afterwards.  Returns the number of programs exercised."""
        assert not self._by_slot and self._pending.empty(), "warmup must run on an idle engine"
        if self.device.type == "cuda":
            from ..ops import build

            build.build_all()
        n, k_max = self.steps_per_sync, self.frames_per_dispatch
        top_bucket = max(self.ecfg.prefill_buckets)
        cbuckets = sorted(b for b in self.ecfg.context_buckets if b <= self.ecfg.max_seq_len)
        burst = max(1, min(burst, self.ecfg.max_slots))
        js = {1 << i for i in range(burst.bit_length()) if (1 << i) <= burst}
        self._max_batch_j = max(js)
        audio = self._codec is not None
        ks = sorted({1, k_max}) if audio else [1]
        chunk_programs, frame_programs = set(), set()
        for L in prompt_lens:
            L = min(L, self.ecfg.max_seq_len - 4)
            if L <= top_bucket:
                rb = _bucket_for(L, self.ecfg.prefill_buckets)
                chunk_programs.update((rb, self._hist_bucket(rb), True, j) for j in js)
            else:
                for fine in (True, False):
                    for _off, clen, hist, final in self._plan_chunks(L, fine):
                        chunk_programs.update((clen, hist, final, j) for j in js)
            lag = n + n * k_max + 2
            start = min(L + lag, self.ecfg.max_seq_len)
            end = min(L + max_new_tokens + lag, self.ecfg.max_seq_len)
            for b in cbuckets:
                if b >= start:
                    frame_programs.update((b, k) for k in ks)
                if b >= end:
                    break
        # on the card each program runs twice: its capture, then a first
        # replay, whose one-time launch costs then fall in warmup
        runs = 2 if self.programs.graphs else 1
        for clen, hist, final, j in sorted(chunk_programs):
            jobs = [{"ids": [0], "offset": 0, "slot": s, "seed": 0, "allowed": 1,
                     "audio": False, "samp": (0.6, 0.9, 1.1),
                     "stops": np.full((_MAX_CUSTOM_STOPS,), -1, np.int32)} for s in range(j)]
            for _ in range(runs):
                self._prefill_round(jobs, clen, hist, final)
        self._gate.fill_(True)
        for b, k in sorted(frame_programs):
            for _ in range(runs):
                self._run_program(b, k, audio)
        self._release_all()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return len(chunk_programs) + len(frame_programs)

    # ------------------------------------------------------------ internals

    def _ensure_running(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_event_loop().create_task(self._run())

    def _to_dev(self, values, dtype) -> torch.Tensor:
        """A small host array on the device, without waiting for the
        device: pinned memory and a non-blocking copy on the card."""
        t = torch.as_tensor(np.asarray(values)).to(dtype)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

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
            if self.trace is not None:
                self.trace.request_end(req)
            req.token_queue.put_nowait(None)
            if req.audio:
                req.pcm_queue.put_nowait(None)

    def _clear_slots(self, sel) -> None:
        """Reset the slot-table rows ``sel`` (an int or ``slice(None)``)."""
        self.active[sel] = False
        self.lengths[sel] = 0
        self.remaining[sel] = 0
        self.is_audio[sel] = False
        self.custom_stops[sel] = -1
        self.presence[sel] = False
        if self._codec is not None:
            for t in (self.ring, self.partial, self.pcnt, self.fcnt, self.audio_pos):
                t[sel] = 0
            self.frame_done[sel] = False

    def _evict(self, slot: int) -> None:
        """Free one slot's device state; other slots are untouched."""
        self._clear_slots(slot)
        self._by_slot.pop(slot, None)
        if slot not in self._free:
            self._free.append(slot)

    def _release_all(self) -> None:
        self._clear_slots(slice(None))
        self.seeds.zero_()
        self.draws.zero_()
        # warmup's sampled tokens too (JAX keeps them): a frame's decode of
        # an idle lane writes K/V from its last token at position lengths = 0
        # (ROADMAP queue 3), so what it writes must not depend on warmup
        self.last_tokens.zero_()

    def _admit(self, req: Request) -> None:
        # the seed fixes the slot's whole sampling stream
        if req.sampling.seed is not None:
            seed = int(req.sampling.seed) & 0xFFFFFFFF
        else:
            seed = int(torch.randint(0, 2**62, (1,), generator=self._seed_gen))
        slot = self._free.pop()
        req.slot = slot
        if self.trace is not None:
            self.trace.request_phase(req, "request.queue")
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
        sp = req.sampling
        # chunk plan frozen at admission: fine rounds only when some stream
        # is already decoding.  No dispatch here: a burst admits whole, so
        # its jobs stay in lockstep and share rounds.
        fine = any(r.state is RequestState.DECODING for r in self._by_slot.values())
        self._prefill_jobs.append({
            "req": req, "slot": slot, "ids": list(ids), "offset": 0, "stops": stops,
            "seed": seed, "fine": fine, "allowed": req.allowed, "audio": req.audio,
            "samp": (sp.temperature, sp.top_p, sp.repetition_penalty)})

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
        """Run at most ONE chunk round: the oldest live job and every job in
        lockstep with it (same next chunk), at the largest power-of-two
        width the group fills, capped at the widest width ``warmup`` ran
        (JAX ``engine.py:1289-1290``), so a burst wider than warmup planned
        lands on a captured program; the rest go next round.  Final rounds
        leave their first tokens on the device in ``_pending_first``."""
        if self._pending_lane_resets:
            from ..codec.stream_decode import reset_lanes

            mask = np.zeros((self.ecfg.max_slots,), bool)
            mask[sorted(self._pending_lane_resets)] = True
            self._pending_lane_resets.clear()
            reset_lanes(self._snac_state, self._to_dev(mask, torch.bool))
        self._prefill_jobs = [
            j for j in self._prefill_jobs
            if not j["req"].done and self._by_slot.get(j["slot"]) is j["req"]
        ]
        if not self._prefill_jobs:
            return
        desc = self._job_next(self._prefill_jobs[0])
        group = [j for j in self._prefill_jobs if self._job_next(j) == desc]
        take = 1 << (len(group).bit_length() - 1)
        if self._max_batch_j:
            take = min(take, self._max_batch_j)
        group = group[:take]
        final, clen, hist = desc
        first = self._prefill_round(group, clen, hist, final)
        if not final:
            for job in group:
                job["offset"] += clen
            return
        for i, job in enumerate(group):
            job["req"].state = RequestState.DECODING
            self._pending_first.append((job["slot"], job["req"], first[i:i + 1]))
            if self.trace is not None:
                self.trace.request_phase(job["req"], "request.prefill")
        done = {id(j) for j in group}
        self._prefill_jobs = [j for j in self._prefill_jobs if id(j) not in done]

    @torch.no_grad()
    def _prefill_round(self, group: List[dict], clen: int, hist: int,
                       final: bool) -> Optional[torch.Tensor]:
        """One chunk of each job in ``group`` (all at the same chunk width
        and history bucket) in one batched pass; a final round samples each
        job's first token and seeds its slot, all on the device.  Returns
        the (J,) first tokens, or None.

        The round is the program of key ``("prefill", clen, hist, final, J,
        banded, lenient, w8a8)`` (JAX's static arguments): the host writes
        the jobs into that key's static buffers, on the stream, before the
        program runs (on the card: replays), so no copy is captured.  The
        first tokens are copied out of the program's outputs, which the
        next round of the same key overwrites."""
        with self._span("engine.prefill_round", device=True):
            J = len(group)
            M = _MAX_CUSTOM_STOPS
            # per job: chunk tokens, then length, offset, slot, context length,
            # budget, audio flag, seed, stop ids (_prefill_program's columns)
            ints = np.zeros((J, clen + 7 + M), np.int64)
            for i, job in enumerate(group):
                off = job["offset"]
                # device-indexed cache writes must stay inside the cache
                assert off + clen <= self.ecfg.max_seq_len, (off, clen, self.ecfg.max_seq_len)
                part = job["ids"][off: off + clen]
                ints[i, : len(part)] = part
                ints[i, clen: clen + 7] = (len(part), off, job["slot"], off + len(part),
                                           job["allowed"], int(job["audio"]), job["seed"])
                ints[i, clen + 7:] = job["stops"]
            samp = np.asarray([job["samp"] for job in group], np.float32)
            key = ("prefill", clen, hist, final, J, self.ecfg.banded_sampling,
                   self.ecfg.lenient_audio_codes, self._w8a8)
            inputs = self._prefill_inputs.get(key)
            if inputs is None:
                inputs = self._prefill_inputs[key] = StaticInputs(
                    [(ints.shape, torch.int64), (samp.shape, torch.float32)], self.device)
            with self._span("engine.stage_inputs"):
                inputs.stage((ints, samp))
            bufs = inputs.bufs
            mine = None
            if self._data_split:  # the jobs whose slots this rank's cache holds
                lo, hi = self._slots.start, self._slots.stop
                mine = [i for i, job in enumerate(group) if lo <= job["slot"] < hi]
            with self._span("engine.replay"):
                outs = self.programs.run(
                    key, lambda: self._prefill_program(bufs, clen, hist, final, mine),
                    graph=self.prefill_graphs and mine is None)
            self.prefill_rounds[J] += 1
            return outs[0].clone() if final else None

    def _prefill_program(self, bufs, clen: int, hist: int, final: bool,
                         mine: Optional[List[int]]) -> tuple:
        """The round itself, from the key's buffers (JAX ``_prefill_chunk`` /
        ``_prefill_chunk_batch``): the batched chunk, the chunk's real
        tokens marked seen, and in a final round the first tokens sampled
        and the slots seeded.  ``mine`` (a data split only) lists the jobs
        this rank's cache holds; None means every job.  Returns
        ``(first tokens (J,),)`` or ``()``."""
        ints, samp = bufs
        J = ints.shape[0]
        toks = ints[:, :clen]
        lens, offs, sl = ints[:, clen], ints[:, clen + 1], ints[:, clen + 2]
        sel = slice(None) if mine is None else torch.tensor(mine, device=self.device)
        logits = None
        if mine is None or mine:
            logits = llama_prefill_chunk_batch(
                self.params, toks[sel].int(), self.cfg, self.cache, offs[sel].int(),
                (sl[sel] - self._slots.start).int(), lens[sel].int(), hist_bucket=hist,
                w8a8=self._w8a8, tp=self.tp)
        # each chunk's real tokens count as seen for the repetition penalty
        # (one scatter of counts: padding adds 0, so no write can disagree)
        real = torch.arange(clen, device=self.device)[None, :] < lens[:, None]
        seen = torch.zeros((J, self.presence.shape[1]), dtype=torch.int32, device=self.device)
        seen.scatter_add_(1, toks, real.int())
        self.presence[sl] = self.presence[sl] | (seen > 0)
        if not final:
            return ()
        ctx, allowed, audio = ints[:, clen + 3], ints[:, clen + 4], ints[:, clen + 5].bool()
        seeds, stops = ints[:, clen + 6], ints[:, clen + 7:]
        first = torch.full((J,), -1, dtype=torch.int32, device=self.device)
        if mine is None or mine:
            if self.ecfg.banded_sampling:  # first audio codes sample from band 0
                logits = _band_mask_logits(logits, audio[sel], torch.zeros_like(seeds[sel]))
            first[sel] = sample_logits(
                logits, seeds[sel], torch.zeros_like(seeds[sel]), temperature=samp[sel, 0],
                top_p=samp[sel, 1], repetition_penalty=samp[sel, 2],
                presence=self.presence[sl[sel]], vocab_size=self.cfg.vocab_size)
        if self._data is not None:  # each job's token from the data rank that owns it
            from ..parallel.collectives import all_reduce

            all_reduce(first, self._data, torch.distributed.ReduceOp.MAX)
        # (device values throughout: a host scalar would be a copy in the graph)
        self.presence[sl, first.long()] = torch.ones_like(first, dtype=torch.bool)
        self.lengths[sl] = ctx.int()
        self.last_tokens[sl] = first
        self.temp[sl] = samp[:, 0]
        self.top_p[sl] = samp[:, 1]
        self.rep_pen[sl] = samp[:, 2]
        self.active[sl] = allowed > 1
        self.remaining[sl] = (allowed - 1).int()
        self.is_audio[sl] = audio
        self.custom_stops[sl] = stops.int()
        self.seeds[sl] = seeds
        self.draws[sl] = torch.ones_like(seeds)
        if self._codec is not None:
            # the first codes enter the ring as a decode step's would: a (B,)
            # token row with -1 for the slots outside the group
            row = torch.full((self.ecfg.max_slots,), -1, dtype=torch.int32, device=self.device)
            row[sl] = first
            self._ring_push(row, self.ecfg.lenient_audio_codes)
        return (first,)

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
            if self.trace is not None and not req.audio:  # audio ends with its last hop
                self.trace.request_end(req)
            req.token_queue.put_nowait(None)

    def _context_bucket(self, n_steps: int) -> Optional[int]:
        """Smallest bucket covering every live context through this
        dispatch: host counts lag the device by up to one frame in flight
        and one pending first token, as in the JAX engine."""
        if not self._by_slot:
            return None
        need = (max(r.ctx_len + r.generated for r in self._by_slot.values())
                + n_steps + self.steps_per_sync * self.frames_per_dispatch + 2)
        need = min(need, self.ecfg.max_seq_len)
        for b in sorted(self.ecfg.context_buckets):
            if need <= b <= self.ecfg.max_seq_len:
                return b
        return None  # full allocated context

    def _backpressure_gate(self) -> Optional[np.ndarray]:
        """(B,) bool gate from consumer-queue depth, or None when no live
        slot can take a frame.  On a mesh a slot is gated when any rank's
        consumer is saturated (agreed by a host all-reduce)."""
        with self._span("engine.gate"):
            gate = np.ones((self.ecfg.max_slots,), bool)
            for slot, req in self._by_slot.items():
                depth = req.pcm_queue.qsize() if req.audio else req.token_queue.qsize()
                limit = self.ecfg.max_queued_hops if req.audio else self.ecfg.max_queued_tokens
                if depth >= limit:
                    gate[slot] = False
            if self._ctrl is not None:
                agreed = torch.from_numpy(gate.astype(np.int64))
                torch.distributed.all_reduce(agreed, torch.distributed.ReduceOp.MIN,
                                             group=self._ctrl)
                gate = agreed.numpy().astype(bool)
            any_ready = any(gate[slot] and req.state is RequestState.DECODING
                            for slot, req in self._by_slot.items())
            return gate if any_ready else None

    def _agree(self) -> bool:
        """The top of a loop turn: fixes how many queued requests to admit
        and applies pending cancellations; False once the engine is closed.
        On a mesh every rank takes the least backlog, the union of the
        cancellations and closes once every rank has closed."""
        n = self._pending.qsize()
        if self._ctrl is None:
            self._agreed_pending = n
            return not self._closed
        B = self.ecfg.max_slots
        keep = np.ones((B,), np.int64)
        keep[sorted(self._cancel_slots)] = 0
        self._cancel_slots.clear()
        vec = torch.from_numpy(np.concatenate([[n, int(not self._closed)], keep]))
        torch.distributed.all_reduce(vec, torch.distributed.ReduceOp.MIN, group=self._ctrl)
        vec = vec.tolist()
        self._agreed_pending = vec[0]
        for slot in [s for s in range(B) if not vec[2 + s]]:
            req = self._by_slot.get(slot)
            if req is not None:
                if not req.done:  # cancelled on another rank
                    self.cancel(req)
                    self._cancel_slots.discard(slot)
                self._evict(slot)
        # eviction order can differ between ranks (a cancelled request stops
        # routing at once where it was cancelled): admit from a sorted list
        self._free.sort(reverse=True)
        return bool(vec[1])

    def _attn_for(self, bucket: Optional[int]) -> str:
        """Resolve attn_impl="auto".  On one card (CUDA, no mesh) the
        kernels' bytes follow each slot's live length, where the dense
        branch reads every slot over the whole bucket: a bf16 cache takes
        the layered kernel at every bucket, an int8 cache the slot kernel
        at buckets >= ``pallas_min_bucket`` (as in JAX).  The shape plays no
        part: a (head_dim, H // KV) the kernels do not take raises in their
        wrappers (``flash_decode_supported``).  Everything else, and every
        mesh engine (as in JAX), takes the dense bucketed attention.  An
        explicit "kernel" on a mesh runs the kernel on the rank's own
        heads."""
        if self.attn_impl != "auto":
            return self.attn_impl
        cache = self.ecfg.cache_dtype
        if (self.device.type == "cuda" and self.mesh is None
                and (cache == "bfloat16"
                     or (cache == "int8"
                         and (bucket or self.ecfg.max_seq_len) >= self.ecfg.pallas_min_bucket))):
            return "kernel"
        return "dense"

    def _trunk_path(self) -> str:
        """"kernel" where the decode step's whole elementwise chain (add +
        norm, RoPE + cache write, SwiGLU) runs as the trunk kernels (on the
        CPU their twins: ``model/llama.py: decode_trunk_parts``), else
        "plain": any part of it as plain ops (an int8 cache, unfused
        weights under tensor parallelism, fp32 activations)."""
        n_local = self._slots.stop - self._slots.start
        parts = decode_trunk_parts(self.params, self.tp.local_cfg(self.cfg), self.cache, n_local)
        return "kernel" if all(parts) else "plain"

    # -------------------------------------------------- the frame program

    def _decode_core(self, attn_impl: str, bucket, banded: bool,
                     stamp: Optional[Stamps] = None):
        """One decode + sample step over the slot table; returns (B,) tokens,
        -1 on lanes that did not emit.  A lane's draw counter advances only
        on steps where it emits.  ``stamp`` marks the step's stages."""
        if stamp is not None:
            stamp("step")
        active = self.active & self._gate
        sl = self._slots  # this rank's slots: all of them without a data split
        logits = llama_decode_step(self.params, self.last_tokens[sl], self.cfg, self.cache,
                                   self.lengths[sl], active=active[sl], attn_impl=attn_impl,
                                   bucket=bucket, tp=self.tp, stamp=stamp)
        if stamp is not None:
            stamp("trunk")
        if banded:
            logits = _band_mask_logits(logits, self.is_audio[sl], self.audio_pos[sl])
        toks = sample_logits(logits, self.seeds[sl], self.draws[sl], temperature=self.temp[sl],
                             top_p=self.top_p[sl], repetition_penalty=self.rep_pen[sl],
                             presence=self.presence[sl], vocab_size=self.cfg.vocab_size)
        toks = self._gather_slots(toks)
        if stamp is not None:
            stamp("sampled")
        toks = torch.where(active, toks, torch.zeros_like(toks))
        idx = (self._rows, toks.long())
        self.presence[idx] = self.presence[idx] | active
        self.lengths.add_(active.to(torch.int32))
        self.draws.add_(active.to(torch.int64))
        self.last_tokens.copy_(torch.where(active, toks, self.last_tokens))
        return torch.where(active, toks, torch.full_like(toks, -1))

    def _gather_slots(self, t: torch.Tensor) -> torch.Tensor:
        """Every slot's values from each data rank's block of them."""
        from ..parallel.collectives import all_gather

        return all_gather(t, 0, self._data)

    def _post_step(self, toks) -> None:
        """A lane stops on a default or custom stop id or an exhausted budget."""
        emitted = toks >= 0
        is_stop = emitted & (toks[:, None] == self.custom_stops).any(dim=1)
        for s in self._stop_ids:
            is_stop = is_stop | (toks == s)
        self.remaining.sub_(emitted.to(torch.int32))
        self.active.copy_(self.active & ~is_stop & (self.remaining > 0))

    def _ring_push(self, toks, lenient: bool) -> None:
        """Append one step's codes to the per-slot device code ring; at most
        one frame completes per slot per frame phase."""
        valid, code = _audio_code(toks, self.audio_pos, lenient)
        valid = valid & self.is_audio  # text lanes never enter the ring
        sel = self._frame_lanes[None, :] == self.pcnt[:, None]
        partial = torch.where(valid[:, None] & sel, code[:, None], self.partial)
        pcnt2 = self.pcnt + valid.to(torch.int32)
        done = pcnt2 >= _FRAME_TOKENS
        shifted = torch.cat([self.ring[:, _FRAME_TOKENS:], partial], dim=1)
        self.ring.copy_(torch.where(done[:, None], shifted, self.ring))
        self.partial.copy_(torch.where(done[:, None], torch.zeros_like(partial), partial))
        self.pcnt.copy_(torch.where(done, torch.zeros_like(pcnt2), pcnt2))
        self.fcnt.add_(done.to(torch.int32))
        self.audio_pos.add_(valid.to(torch.int32))
        self.frame_done.logical_or_(done)

    def _snac_hop(self, window, commit):
        """One batched streaming SNAC hop; the codec state moves in place."""
        snac_params, snac_cfg = self._codec
        pcm, new_state = snac_stream_body(snac_params, window, self._snac_state, commit,
                                          cfg=snac_cfg)
        for name, t in new_state.items():
            self._snac_state[name].copy_(t)
        return pcm

    def _frame_program(self, *, bucket, attn: str, n_steps: int, n_frames: int,
                       audio: bool, banded: bool, lenient: bool) -> tuple:
        """The fused frame program (JAX ``_decode_audio_multi`` /
        ``_decode_multi``): ``n_frames`` x ``n_steps`` decode steps; in audio
        mode each frame phase ends with the batched SNAC hop, run for every
        lane with head/steady commit masks and PCM zeroed where no lane
        emits.  Returns ``(toks (n_frames * n_steps, B),)`` or, in audio
        mode, also ``pcm (n_frames, B, frame_samples)`` int16 and
        ``emit (n_frames, B)``.  Built while the trace is on, it also marks
        its stage boundaries (``trace.py``) and returns the marks last."""
        rows, pcms, emits = [], [], []
        B = self.ecfg.max_slots
        stamp = None
        if self.trace is not None:
            per_step = 4 + 2 * self.cfg.num_layers
            stamp = Stamps(n_frames * (n_steps * per_step + 2) + 1, self.device)
        for _ in range(n_frames):
            if stamp is not None:
                stamp("frame")
            if audio:
                self.frame_done.zero_()
            for _ in range(n_steps):
                toks = self._decode_core(attn, bucket, banded, stamp)
                self._post_step(toks)
                if audio:
                    self._ring_push(toks, lenient)
                if stamp is not None:
                    stamp("bookkept")
                rows.append(toks)
            if not audio:
                continue
            fs = self._codec[1].frame_samples
            head = self.frame_done & (self.fcnt == 1)
            steady = self.frame_done & (self.fcnt >= WINDOW_FRAMES)
            newest = self.ring[:, -_FRAME_TOKENS:]
            window = torch.where(head[:, None], newest.repeat(1, WINDOW_FRAMES), self.ring)
            pcm_win = self._snac_hop(window, steady)
            ws = torch.where(head, 0, EMIT_SLOT)
            pcm = pcm_win.reshape(B, WINDOW_FRAMES, fs)[self._rows, ws]
            emit = head | steady
            pcms.append(torch.where(emit[:, None], pcm, torch.zeros_like(pcm)))
            emits.append(emit)
            if stamp is not None:
                stamp("snac")
        outs = ((torch.stack(rows), torch.stack(pcms), torch.stack(emits)) if audio
                else (torch.stack(rows),))
        if stamp is None:
            return outs
        stamp("end")
        return outs + (stamp.taken(),)

    @torch.no_grad()
    def _run_program(self, bucket, k: int, audio: bool) -> tuple:
        """Run (on the card: replay) the frame program of one key."""
        banded = audio and self.ecfg.banded_sampling
        lenient = self.ecfg.lenient_audio_codes
        attn = self._attn_for(bucket)
        key = (bucket, attn, self.steps_per_sync, k, audio, banded, lenient)
        with self._span("engine.replay"):
            return self.programs.run(key, lambda: self._frame_program(
                bucket=bucket, attn=attn, n_steps=self.steps_per_sync, n_frames=k,
                audio=audio, banded=banded, lenient=lenient))

    def _dispatch_frame(self, gate: np.ndarray):
        """Issue one frame dispatch; returns ({"toks", and in audio mode
        "pcm" and "emit"; "stamps" from a program that took them: device
        tensors}, slot snapshot)."""
        with self._span("engine.dispatch"):
            audio_reqs = [r for r in self._by_slot.values() if r.audio]
            audio = self._codec is not None and bool(audio_reqs)
            k = 1
            if audio and not (self._prefill_jobs or self._pending_first
                              # an admission is imminent only when a slot is free
                              or (self._free and self._agreed_pending)
                              or any(r.planner.emitted == 0 for r in audio_reqs)):
                k = self.frames_per_dispatch
            bucket = self._context_bucket(self.steps_per_sync * k)
            with self._span("engine.stage_inputs"):
                self._gate_in.stage((gate,))
            outs = self._run_program(bucket, k, audio)
            if self.trace is not None:
                self.trace.counters[f"attn_{self._attn_for(bucket)}_frames"] += k
                self.trace.counters[f"trunk_{self._trunk_path()}_frames"] += k
            names = ("toks", "pcm", "emit") if audio else ("toks",)
            return dict(zip(names + ("stamps",), outs)), dict(self._by_slot)

    # ---------------------------------------------------------- readback

    def _readback(self, tensors: Dict[str, torch.Tensor],
                  frame: bool = False) -> "asyncio.Future":
        """Enqueue device -> host copies of ``tensors``; the future yields
        {name: numpy array} once they landed, awaited off the event loop.
        A frame's copies go to this turn's set of pinned buffers (two sets:
        a set is reused only after the frame two dispatches back was
        routed); a flush hop's to buffers of its own."""
        with self._span("engine.readback_issue"):
            loop = asyncio.get_running_loop()
            if self.device.type != "cuda":
                fut = loop.create_future()
                fut.set_result({k: t.numpy().copy() for k, t in tensors.items()})
                return fut
            bufs = self._host_sets[self._host_turn] if frame else {}
            hosts = {}
            for name, t in tensors.items():
                key = (name, tuple(t.shape), t.dtype)
                if key not in bufs:
                    bufs[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                hosts[name] = bufs[key]
                hosts[name].copy_(t, non_blocking=True)
            if frame:
                self._host_turn ^= 1
            event = torch.cuda.Event()
            event.record()

            def wait():
                event.synchronize()
                return {k: h.numpy().copy() for k, h in hosts.items()}

            return loop.run_in_executor(self._readback_pool, wait)

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

    def _finish_routing(self, pending_hops, finished_audio) -> None:
        if pending_hops:  # end-of-stream flush hops only
            self._run_audio_hops(pending_hops)
        for req in finished_audio:
            self._pending_audio.append(("eos", req))

    def _route_firsts(self, firsts, values, pending_hops, finished_audio) -> None:
        for (slot, req, _), val in zip(firsts, values):
            if req.done or self._by_slot.get(slot) is not req:
                continue  # cancelled while the prefill was in flight
            self._route_token(slot, req, int(val), pending_hops, finished_audio)

    def _flush_first_tokens(self) -> None:
        """Read back first tokens not yet routed, for the idle and parked
        branches where no frame is in flight to carry them."""
        if not self._pending_first:
            return
        pending, self._pending_first = self._pending_first, []
        values = torch.cat([f[2] for f in pending]).cpu().numpy()
        pending_hops: List[tuple] = []
        finished_audio: List[Request] = []
        self._route_firsts(pending, values, pending_hops, finished_audio)
        self._finish_routing(pending_hops, finished_audio)

    def _process_frame(self, slot_map, firsts, host) -> None:
        """Route one frame's readback: first tokens sampled before the frame
        (their codes entered the ring first), then the tokens phase by
        phase; a lane's hop reaches the consumer only when the host planner
        produced it from the routed tokens (a lane that stopped
        mid-dispatch emits nothing more)."""
        with self._span("engine.route"):
            pending_hops: List[tuple] = []
            finished_audio: List[Request] = []
            if firsts:
                self._route_firsts(firsts, host["firsts"], pending_hops, finished_audio)
            toks = host["toks"]
            self.steps += toks.shape[0]
            pcm, emit = host.get("pcm"), host.get("emit")
            n_phases = 1 if pcm is None else pcm.shape[0]
            rows_per = toks.shape[0] // n_phases
            routed = 0
            for ph in range(n_phases):
                host_hops: set = set()
                for step_row in toks[ph * rows_per:(ph + 1) * rows_per]:
                    for slot, req in slot_map.items():
                        if (req.state is not RequestState.DECODING
                                or self._by_slot.get(slot) is not req):
                            continue
                        token = int(step_row[slot])
                        if token < 0:
                            continue
                        routed += 1
                        if self._route_token(slot, req, token, pending_hops, finished_audio):
                            host_hops.add(slot)
                if pcm is None:
                    continue
                for slot, req in slot_map.items():
                    if (req.audio and emit[ph, slot] and slot in host_hops
                            and req.state is not RequestState.CANCELLED):
                        req.pcm_queue.put_nowait(pcm[ph, slot].tobytes())
                        if self.trace is not None:
                            self.trace.request_phase(req, "request.first_hop")
            self._finish_routing(pending_hops, finished_audio)
            if self.trace is not None:
                self.trace.note_frame(toks.shape[0] * self.ecfg.max_slots, routed,
                                      host.get("stamps"))

    @torch.no_grad()
    def _run_audio_hops(self, pending: List[tuple]) -> None:
        """End-of-stream flush hops: all lanes' hops of one round in one
        batched call with per-lane commit masks; each round's PCM readback
        is issued at once and routed by ``_flush_audio``."""
        B = self.ecfg.max_slots
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
            pcm = self._snac_hop(self._to_dev(windows, torch.int32),
                                 self._to_dev(commit, torch.bool))
            self._pending_audio.append(("pcm", self._readback({"pcm": pcm}), emits))

    async def _flush_audio(self, force: bool = True) -> None:
        """Route dispatched flush-hop PCM, strictly in dispatch order; with
        ``force`` False, entries whose readback is still in flight are left
        for a later call so the dispatch cadence never stalls."""
        with self._span("engine.flush_audio"):
            fs = self._codec[1].frame_samples if self._codec else 0
            while self._pending_audio:
                entry = self._pending_audio[0]
                if entry[0] == "eos":
                    self._pending_audio.pop(0)
                    if self.trace is not None:
                        self.trace.request_end(entry[1])
                    entry[1].pcm_queue.put_nowait(None)
                    continue
                _, fut, emits = entry
                if not force and not fut.done():
                    return
                pcm = (await fut)["pcm"]
                self._pending_audio.pop(0)
                for slot, req, ws in emits:
                    if req.state is not RequestState.CANCELLED:
                        req.pcm_queue.put_nowait(pcm[slot, ws * fs:(ws + 1) * fs].tobytes())
                        if self.trace is not None:
                            self.trace.request_phase(req, "request.first_hop")

    # ------------------------------------------------------------- loop

    async def _settle(self, inflight) -> None:
        """Await a frame's (already issued) readback and route it."""
        slot_map, firsts, fut = inflight
        with self._span("engine.readback_wait"):
            host = await fut
        self._process_frame(slot_map, firsts, host)

    async def _drain(self, inflight):
        if inflight is not None:
            await self._settle(inflight)
        return None

    async def _park(self) -> None:
        with self._span("engine.park"):
            self._wake.clear()
            try:
                await asyncio.wait_for(self._wake.wait(), timeout=0.5)
            except asyncio.TimeoutError:
                pass

    def _admit_backlog(self) -> None:
        """Admit the (agreed) backlog, up to the free slots."""
        with self._span("engine.admit"):
            deferred = []
            for _ in range(self._agreed_pending):
                req = self._pending.get_nowait()
                cancelled = req.state is RequestState.CANCELLED
                if cancelled and self._ctrl is None:
                    continue
                if self._free:
                    self._guarded_admit(req)
                    if cancelled and req.slot is not None:
                        # on a mesh a slot is freed on every rank at once
                        req.state = RequestState.CANCELLED
                        self._cancel_slots.add(req.slot)
                else:
                    deferred.append(req)
            rest = []
            while not self._pending.empty():
                rest.append(self._pending.get_nowait())
            for req in deferred + rest:
                self._pending.put_nowait(req)
            self._agreed_pending = len(deferred)  # still waiting for a slot

    async def _run(self) -> None:
        # One frame in flight: dispatch frame N, enqueue its readback, run
        # at most one prefill round, then route frame N-1 while N runs.
        inflight = None  # (slot snapshot, firsts, readback future)
        while self._agree():
            with self._span("engine.turn"):
                inflight = await self._turn(inflight)
        await self._drain(inflight)
        self._flush_first_tokens()
        await self._flush_audio()

    async def _turn(self, inflight):
        """One turn of the loop; returns the frame left in flight."""
        if self._free and self._agreed_pending:
            self._admit_backlog()
        if not self._by_slot:
            inflight = await self._drain(inflight)
            if self._by_slot or not self._pending.empty():
                return inflight  # settling surfaced new work
            self._flush_first_tokens()
            await self._flush_audio()
            await self._park()
            return inflight
        gate = self._backpressure_gate()
        if gate is None:
            inflight = await self._drain(inflight)
            if self._prefill_jobs:
                # nothing decodable yet: keep admissions moving; the
                # first tokens ride the next frame's readback
                self._advance_prefill()
                await self._flush_audio()
                await asyncio.sleep(0)
                return inflight
            # every live consumer is saturated: park until one drains
            self._flush_first_tokens()
            await self._flush_audio()
            self._wake.clear()
            if (self._backpressure_gate() is not None
                    or not self._pending.empty() or self._closed):
                return inflight
            await self._park()
            return inflight
        payload, slot_map = self._dispatch_frame(gate)
        # firsts sampled before this frame ride its readback
        firsts, self._pending_first = self._pending_first, []
        if firsts:
            payload["firsts"] = torch.cat([f[2] for f in firsts])
        fut = self._readback(payload, frame=True)
        # at most one prefill round rides behind each frame
        self._advance_prefill()
        # route the previous frame while this one runs
        if inflight is not None:
            await self._settle(inflight)
        await self._flush_audio(force=False)
        await asyncio.sleep(0)
        return (slot_map, firsts, fut)
