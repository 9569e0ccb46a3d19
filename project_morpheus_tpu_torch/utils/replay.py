"""Deterministic replay: rebuild a WAV from orchestrator timeline logs
(port of utils/replay.py; ``python -m project_morpheus_tpu_torch.utils.replay
log.jsonl -o out.wav``).

Functional parity with reference replay.py:10-43 — accepts JSON-lines or a
JSON array (or the ``{"events": [...]}`` envelope save_timeline writes),
concatenates the base64 PCM of each event, and writes PCM16 mono WAV.
Serving is stateless; "resume" of any run is replay from its log
(SURVEY.md §5.4).
"""
from __future__ import annotations

import argparse
import base64
import json
import wave
from pathlib import Path
from typing import Iterable, List


def load_events(path) -> List[dict]:
    text = Path(path).read_text(encoding="utf-8").strip()
    if not text:
        return []
    try:
        data = json.loads(text)
        if isinstance(data, dict):
            data = data.get("events", [])
        return list(data)
    except json.JSONDecodeError:
        return [json.loads(line) for line in text.splitlines() if line.strip()]


def rebuild_pcm(events: Iterable[dict]) -> bytes:
    out = bytearray()
    for event in events:
        pcm_b64 = event.get("pcm")
        if pcm_b64:
            out.extend(base64.b64decode(pcm_b64))
    return bytes(out)


def replay_to_wav(log_path, out_path, sample_rate: int = 24_000) -> int:
    pcm = rebuild_pcm(load_events(log_path))
    with wave.open(str(out_path), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(pcm)
    return len(pcm)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Rebuild audio from timeline logs")
    parser.add_argument("log", help="timeline log (JSON lines, array, or envelope)")
    parser.add_argument("-o", "--out", default="replay.wav")
    parser.add_argument("-r", "--rate", type=int, default=24_000)
    args = parser.parse_args(argv)
    n = replay_to_wav(args.log, args.out, args.rate)
    print(f"wrote {args.out} ({n} PCM bytes)")


if __name__ == "__main__":
    main()
