"""The port's adapter layer against the JAX package's, in mock engine mode
(``ORPHEUS_ENGINE_MODE=mock``: audio-band tokens, no model): registry
descriptors, ``MockEngine`` traces, the local adapter's pull contract,
``remote_sse`` through a stubbed transport (retries included), its PCM
against the exact stream decoder, the SNAC ``.npz`` path, and the
``OrpheusModel`` facade.  Token ids and strings are compared exactly; the
remote path's PCM equals the port's exact decoder bit for bit."""
import asyncio
import json

import httpx
import numpy as np
import pytest
import torch

from project_morpheus_tpu.adapters import registry as jax_registry
from project_morpheus_tpu.adapters import runtime as jax_rt
from project_morpheus_tpu.compat import OrpheusModel as JaxOrpheusModel
from project_morpheus_tpu_torch.adapters import VoiceSchema, registry
from project_morpheus_tpu_torch.adapters import remote_backend as rb
from project_morpheus_tpu_torch.adapters import runtime as rt
from project_morpheus_tpu_torch.codec import SNACConfig
from project_morpheus_tpu_torch.codec.frames import custom_number_from_audio_code
from project_morpheus_tpu_torch.codec.stream_decode import ExactStreamDecoder
from project_morpheus_tpu_torch.codec.weights import params_from_torch_state, random_torch_state
from project_morpheus_tpu_torch.compat import OrpheusModel


@pytest.fixture(autouse=True)
def mock_mode(monkeypatch):
    monkeypatch.setenv("ORPHEUS_ENGINE_MODE", "mock")
    monkeypatch.setenv("ORPHEUS_MODEL_SIZE", "tiny")
    monkeypatch.setenv("ORPHEUS_API_URL", "http://fake/v1/completions")
    for key in ("ORPHEUS_SNAC_PATH", "ORPHEUS_CHECKPOINT_PATH", "ORPHEUS_TOKENIZER_PATH"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(jax_rt, "_runtime", None)
    rt.set_runtime(rt.ServingRuntime(device="cpu"))
    yield
    rt.set_runtime(None)


def test_registry_descriptors_match_jax():
    ours, theirs = registry.available(), jax_registry.available()
    assert set(ours) == {"local_torch", "remote_sse"}
    assert ours["remote_sse"] == theirs["remote_sse"]
    assert {**ours["local_torch"], "name": "local_jax"} == theirs["local_jax"]
    adapter = registry.create("local_torch", prompt="x", voice=VoiceSchema(voice="nope"))
    assert adapter.voice == "tara"
    assert registry.create("remote_sse", prompt="x", voice=VoiceSchema(voice="leo")).voice == "leo"


def test_mock_engine_traces_equal_jax():
    async def traces(engine):
        out = []
        for prompt in ([1, 2, 3], [128259, 40, 41, 128009], list(range(300))):
            req = await engine.submit(prompt)
            out.append([t async for t in req.tokens()])
        return out

    ours = asyncio.run(traces(rt.MockEngine(tokens_per_request=7 * 5)))
    theirs = asyncio.run(traces(jax_rt.MockEngine(tokens_per_request=7 * 5)))
    assert ours == theirs and all(len(t) == 35 for t in ours)
    assert all(rt.audio_code_from_token_id(t, i) is not None
               for trace in ours for i, t in enumerate(trace))


def test_local_adapter_pull_contract_on_mock_engine():
    async def go():
        adapter = registry.create("local_torch", prompt="hello", voice=VoiceSchema())
        chunks = []
        while True:
            chunk = await adapter.pull(4096)
            assert len(chunk.pcm) <= 4096
            chunks.append(chunk)
            if chunk.eos:
                break
        runtime = await rt.get_runtime().ensure()
        return chunks, runtime

    chunks, runtime = asyncio.run(go())
    assert isinstance(runtime.engine, rt.MockEngine)
    total = sum(len(c.pcm) for c in chunks)
    assert total == 24 * 2 * runtime.snac_cfg.frame_samples  # 24 frames of PCM16


def _sse(tokens):
    return b"".join(b'data: {"choices": [{"text": "' + t.encode() + b'"}]}\n\n'
                    for t in tokens) + b"data: [DONE]\n\n"


def _exact_pcm(codes, runtime):
    dec = ExactStreamDecoder(runtime.snac_params, runtime.snac_cfg)
    return b"".join(h.tobytes() for h in dec.push_tokens(codes) + dec.flush())


def test_remote_path_pcm_identical_to_exact_decoder():
    """A recorded trace replayed over SSE (merged custom tokens in one
    event, and a non-audio token) gives the exact decoder's PCM."""
    codes = [(i * 37) % 4000 + 1 for i in range(35)]  # 5 frames
    tokens = [f"<custom_token_{custom_number_from_audio_code(c, i)}>" for i, c in enumerate(codes)]
    tokens = [tokens[0] + tokens[1]] + tokens[2:] + ["<|eot_id|>"]
    seen = []

    def handler(request: httpx.Request) -> httpx.Response:
        seen.append(json.loads(request.content))
        return httpx.Response(200, content=_sse(tokens))

    async def go():
        client = httpx.AsyncClient(transport=httpx.MockTransport(handler))
        out = bytearray()
        async for pcm in rb.stream_pcm_from_api("hi", client=client):
            out.extend(pcm)
        await client.aclose()
        return bytes(out), _exact_pcm(codes, await rt.get_runtime().ensure())

    got, want = asyncio.run(go())
    assert seen[0]["stream"] is True and seen[0]["prompt"] == "<|audio|>tara: hi<|eot_id|>"
    assert len(got) == 5 * 2 * rt.get_runtime().snac_cfg.frame_samples
    assert got == want


def test_remote_sse_retries_with_backoff(monkeypatch):
    """Two server errors, then a stream: tokens arrive after backoffs of 1
    and 2 s; three errors raise after the retry budget."""
    delays = []
    real_sleep = asyncio.sleep

    async def fake_sleep(s):
        delays.append(s)
        await real_sleep(0)

    monkeypatch.setattr(rb.asyncio, "sleep", fake_sleep)
    calls = {"n": 0, "fail": 2}

    def handler(request):
        calls["n"] += 1
        if calls["n"] <= calls["fail"]:
            return httpx.Response(500, content=b"boom")
        return httpx.Response(200, content=_sse(["<custom_token_12>", "<custom_token_13>"]))

    async def tokens():
        client = httpx.AsyncClient(transport=httpx.MockTransport(handler))
        try:
            return [t async for t in rb.generate_tokens_from_api("x", client=client)]
        finally:
            await client.aclose()

    assert asyncio.run(tokens()) == ["<custom_token_12>", "<custom_token_13>"]
    assert calls["n"] == 3 and delays == [1, 2]
    calls.update(n=0, fail=3)
    delays.clear()
    with pytest.raises(httpx.HTTPStatusError):
        asyncio.run(tokens())
    assert calls["n"] == 3 and delays == [1, 2]


def test_remote_adapter_pull_contract(monkeypatch):
    codes = [(i * 53) % 4000 + 1 for i in range(28)]
    sse = _sse([f"<custom_token_{custom_number_from_audio_code(c, i)}>"
                for i, c in enumerate(codes)])

    async def go():
        client = httpx.AsyncClient(transport=httpx.MockTransport(
            lambda request: httpx.Response(200, content=sse)))
        real = rb.stream_pcm_from_api
        monkeypatch.setattr(rb, "stream_pcm_from_api",
                            lambda *a, **k: real(*a, client=client, **k))
        adapter = registry.create("remote_sse", prompt="hi", voice=VoiceSchema())
        data = bytearray()
        while True:
            chunk = await adapter.pull(3000)
            assert len(chunk.pcm) <= 3000
            data += chunk.pcm
            if chunk.eos:
                break
        await client.aclose()
        return bytes(data), _exact_pcm(codes, await rt.get_runtime().ensure())

    got, want = asyncio.run(go())
    assert got == want and len(got) > 0


def test_runtime_loads_snac_npz(tmp_path, monkeypatch):
    state = random_torch_state(SNACConfig.snac_24khz(), seed=4)
    np.savez(tmp_path / "snac.npz", **state)
    monkeypatch.setenv("ORPHEUS_SNAC_PATH", str(tmp_path / "snac.npz"))
    runtime = rt.ServingRuntime(device="cpu")
    runtime.build()
    assert runtime.snac_cfg == SNACConfig.snac_24khz()
    want = params_from_torch_state(state, runtime.snac_cfg)
    got = runtime.snac_params
    for path in (("decoder", "out_w"), ("decoder", "in_dw_w"), ("quantizer", 2, "codebook")):
        a, b = got, want
        for key in path:
            a, b = a[key], b[key]
        assert isinstance(a, torch.Tensor) and np.array_equal(a.numpy(), b)
    assert torch.equal(got["decoder"]["blocks"][3]["up_w"],
                       torch.from_numpy(want["decoder"]["blocks"][3]["up_w"]))


def test_orpheus_model_facade_matches_jax():
    port, ref = OrpheusModel(), JaxOrpheusModel()
    try:
        kw = dict(prompt="Hello facade", voice="leo", max_tokens=7 * 6)
        toks = list(port.generate_tokens_sync(**kw))
        assert toks == list(ref.generate_tokens_sync(**kw)) and len(toks) == 42
        pcm = b"".join(port.generate_speech(**kw))
    finally:
        port.close()
        ref.close()
    codes = []
    for i, t in enumerate(toks):
        n = int(t[len("<custom_token_"):-1])
        codes.append(n - 10 - (i % 7) * 4096)
    assert pcm == _exact_pcm(codes, rt.get_runtime())
