"""project_morpheus_tpu_torch: the PyTorch + CUDA port of the JAX package
project_morpheus_tpu, written for one NVIDIA H100.

The same streaming text-to-speech system (an Orpheus Llama-3B-class decoder
emitting SNAC audio tokens, decoded to 24 kHz PCM in 2048-sample hops),
and its trainer.
The JAX package beside it is the reference; every module here is held
against it by ``tests/test_torch_*.py``, and this package imports nothing
of it.

Layer map (mirrors the JAX package):

    server/        aiohttp HTTP/WS API (speech, voices, /ws/tts, adapters,
                   sources, config, barge-in, stats, admin page)
    compat/        OrpheusModel: the orpheus_tts package's synchronous API
    text_sources/  push-mode text inputs (websocket, HTTP poll, CLI pipe)
    adapters/      ServingRuntime (random weights, an HF checkpoint or the
                   trainer's),
                   LocalTorchAdapter, the remote SSE adapter, MockEngine
    orchestrator/  pull loop, chunk ladder, playback/ring buffers, stitcher
    engine/        continuous-batching engine over a slot-table KV cache
    training/      one-card trainer: pretrain, full finetune and LoRA steps
                   (AdamW, chunked-vocab loss), data batching, safetensors
                   checkpoints, the ``python -m ...training`` CLI
    model/         Llama-3.2-class decoder (serving and the full-sequence
                   training forward), HF checkpoint loader, byte-level BPE
                   tokenizer, int8 weights, sampling, layout conversions
    ops/           hand-written Hopper CUDA kernels (flash decode attention,
                   int8 GEMV); the training attention (SDPA on the card,
                   its plain blockwise twin on the CPU)
    codec/         SNAC decoder and encoder, the exact stream decoder, and
                   the windowed and parity stream decoders
    tools/         convert_snac, kernel timing and ablation, profiling
    config.py      layered env-file configuration
    utils/         device selection, text splitting, WAV helpers

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
