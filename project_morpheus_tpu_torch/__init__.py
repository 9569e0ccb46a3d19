"""project_morpheus_tpu_torch: the PyTorch + CUDA port of the JAX package
project_morpheus_tpu, written for one NVIDIA H100.

The same streaming text-to-speech system (an Orpheus Llama-3B-class decoder
emitting SNAC audio tokens, decoded to 24 kHz PCM in 2048-sample hops).
The JAX package beside it is the reference; every module here is held
against it by ``tests/test_torch_*.py``, and this package imports nothing
of it.

Layer map (mirrors the JAX package):

    server/        aiohttp HTTP API (speech, voices, stats)
    adapters/      ServingRuntime + LocalTorchAdapter (pull protocol)
    orchestrator/  pull loop, chunk ladder, playback/ring buffers, stitcher
    engine/        continuous-batching engine over a slot-table KV cache
    model/         Llama-3.2-class decoder, int8 weights, sampling
    ops/           hand-written Hopper CUDA kernels (flash decode attention)
    codec/         SNAC decoder and the exact stateful stream decoder
    utils/         device selection, text splitting, WAV helpers

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
