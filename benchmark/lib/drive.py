"""The measured window: requests sent on the mix's schedule through
``OrpheusEngine.submit(..., audio=True)``, each one's PCM hops read from
``Request.pcm_chunks()`` as the server's adapter reads them, and the
host time of every hop kept.

Open loop: each request is due at its planned offset and sent then,
however far behind the system is; its latency counts from when it was
due.  Closed loop: each client sends its next request when its previous
one's last hop has arrived, until the window closes; clients in groups
of ``burst`` send theirs together once the whole group's have ended, the
groups starting ``stagger_s`` apart.  Requests sent in
the window are driven to completion or to the mix's drain deadline; a
request still running then is cancelled and failed.
"""
from __future__ import annotations

import asyncio
import time
from typing import Callable, Dict, List, Optional

from . import program
from .traffic import AUDIO_BASE, CODEBOOK, FRAME_TOKENS


def _new_record(item, t_sched: float) -> Dict:
    return {"item": item, "t_sched": t_sched, "t_sent": None, "hops": [], "pcm": [],
            "tokens": [], "failed": False, "why": "", "req": None}


async def _serve(engine, mix: Dict, rec: Dict, hop_bytes: int) -> None:
    item = rec["item"]
    rec["t_sent"] = time.perf_counter()
    req = await engine.submit(item.prompt, program.sampling(mix, item), audio=True)
    rec["req"] = req
    async for pcm in req.pcm_chunks():
        rec["hops"].append(time.perf_counter())
        rec["pcm"].append(pcm)
    q = req.token_queue
    while not q.empty():
        tok = q.get_nowait()
        if tok is not None:
            rec["tokens"].append(tok)
    _judge(rec, hop_bytes)


def _judge(rec: Dict, hop_bytes: int) -> None:
    """A request that did not end normally, or whose PCM is malformed
    (another hop count than its frames, a hop of another length), failed."""
    item, req = rec["item"], rec["req"]
    if req is None or req.state.value != "finished":
        rec["failed"], rec["why"] = True, f"state {getattr(req, 'state', None)}"
    elif len(rec["hops"]) != item.frames or any(len(p) != hop_bytes for p in rec["pcm"]):
        rec["failed"], rec["why"] = True, (f"{len(rec['hops'])} hops for {item.frames} frames, "
                                           f"sizes {sorted({len(p) for p in rec['pcm']})}")
    elif len(rec["tokens"]) != item.max_tokens:
        rec["failed"], rec["why"] = True, f"{len(rec['tokens'])} tokens for {item.max_tokens}"
    else:
        off = [(j, t) for j, t in enumerate(rec["tokens"])
               if not 0 <= t - AUDIO_BASE - (j % FRAME_TOKENS) * CODEBOOK < CODEBOOK]
        if off:
            rec["failed"] = True
            rec["why"] = (f"{len(off)} of {len(rec['tokens'])} tokens outside their audio band "
                          f"(greedy {item.greedy}, prompt {len(item.prompt)}): first "
                          f"(position, token) {off[:4]}; tokens before: "
                          f"{rec['tokens'][max(0, off[0][0] - 3):off[0][0]]}")


async def window(engine, mix: Dict, plan: Dict, seconds: float, hop_bytes: int,
                 on_open: Optional[Callable] = None, slice_task: Optional[Callable] = None
                 ) -> Dict:
    """Run the window; returns ``{"records", "t0", "t1", "deadline",
    "late_s"}`` (host perf_counter seconds).  ``on_open`` is called as the
    window opens; ``slice_task(t0, t1)`` is a coroutine run beside it."""
    loop_tasks: List[asyncio.Task] = []
    records: List[Dict] = []
    late: List[float] = []
    t0 = time.perf_counter()
    if on_open is not None:
        on_open(t0)
    t1 = t0 + seconds
    side = asyncio.ensure_future(slice_task(t0, t1)) if slice_task is not None else None
    if plan["loop"] == "open":
        for item in plan["items"]:
            due = t0 + item.at
            wait = due - time.perf_counter()
            if wait > 0:
                await asyncio.sleep(wait)
            late.append(time.perf_counter() - due)
            rec = _new_record(item, due)
            records.append(rec)
            loop_tasks.append(asyncio.ensure_future(_serve(engine, mix, rec, hop_bytes)))
    else:
        pool = iter(plan["items"])

        async def group(n: int, start: float):
            """``n`` clients in lockstep, from ``start`` on: their next
            requests go together, once the last of their previous ones has
            ended."""
            await asyncio.sleep(max(0.0, start - time.perf_counter()))
            t_next = start
            while t_next < t1:
                recs = [_new_record(next(pool), t_next) for _ in range(n)]
                records.extend(recs)
                late.extend([time.perf_counter() - t_next] * n)
                await asyncio.gather(*(_serve(engine, mix, r, hop_bytes) for r in recs))
                t_next = time.perf_counter()

        burst, stagger = plan.get("burst", 1), plan.get("stagger_s", 0.0)
        loop_tasks = [asyncio.ensure_future(group(burst, t0 + g * stagger))
                      for g in range(plan["clients"] // burst)]
        await asyncio.sleep(max(0.0, t1 - time.perf_counter()))
    deadline = t1 + float(mix["drain_s"])
    pending = [t for t in loop_tasks if not t.done()]
    if pending:
        await asyncio.wait(pending, timeout=max(0.0, deadline - time.perf_counter()))
    for rec in records:
        if rec["req"] is not None and not rec["req"].done:
            engine.cancel(rec["req"])
        if rec["req"] is None or not rec["req"].done or rec["req"].state.value != "finished":
            rec["failed"] = True
            rec["why"] = rec["why"] or "not finished by the drain deadline"
    for t in loop_tasks:
        if not t.done():
            t.cancel()
    await asyncio.gather(*loop_tasks, return_exceptions=True)
    if side is not None:
        await side
    return {"records": records, "t0": t0, "t1": t1, "deadline": deadline, "late_s": late}
