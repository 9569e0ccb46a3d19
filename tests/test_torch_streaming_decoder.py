"""The port's windowed and parity SNAC stream decoders
(project_morpheus_tpu_torch.codec.streaming) against the JAX package's
``StreamingSnacDecoder`` on identical weights (both built from the same
seeded numpy state) and one token trace, fed one code at a time.

fp32 on both sides: hop counts and lengths equal exactly; int16 PCM may
differ by the truncation of a last-bit difference (<= 2 LSB), as in
``test_torch_snac.py``."""
import numpy as np
import pytest

from project_morpheus_tpu.codec import SNACConfig as JaxSNACConfig
from project_morpheus_tpu.codec import StreamingSnacDecoder as JaxDecoder
from project_morpheus_tpu.codec import init_snac_params as jax_snac_init
from project_morpheus_tpu_torch.codec import SNACConfig
from project_morpheus_tpu_torch.codec.stream_decode import ExactStreamDecoder, make_stream_decoder
from project_morpheus_tpu_torch.codec.streaming import StreamingSnacDecoder
from project_morpheus_tpu_torch.codec.weights import init_snac_params


@pytest.fixture(scope="module")
def setup():
    cfg = SNACConfig.tiny()
    return cfg, jax_snac_init(JaxSNACConfig.tiny(), seed=3), init_snac_params(cfg, 3, "cpu")


def _run(dec, trace):
    hops = []
    for code in trace:
        hops += dec.push_tokens([code])
    return hops, dec.flush()


# 12 frames (the parity decoder's 49-token window and its rewind), a
# 3-token partial tail; 10 tokens (the parity flush pads to 28)
@pytest.mark.parametrize("n_tokens", [7 * 12 + 3, 10])
@pytest.mark.parametrize("mode", ["native", "parity"])
def test_matches_jax_decoder(setup, mode, n_tokens):
    cfg, jparams, tparams = setup
    trace = np.random.default_rng(n_tokens).integers(0, 4096, n_tokens).tolist()
    jhops, jflush = _run(JaxDecoder(jparams, JaxSNACConfig.tiny(), mode=mode), trace)
    thops, tflush = _run(StreamingSnacDecoder(tparams, cfg, mode=mode), trace)
    assert [h.shape for h in thops] == [h.shape for h in jhops]
    assert [h.shape for h in tflush] == [h.shape for h in jflush]
    assert len(thops) + len(tflush) > 1
    for t, j in zip(thops + tflush, jhops + jflush):
        assert t.dtype == np.int16
        if t.size:
            assert np.abs(t.astype(np.int32) - np.asarray(j, np.int32)).max() <= 2


def test_make_stream_decoder_modes(setup):
    cfg, _, tparams = setup
    assert isinstance(make_stream_decoder(tparams, cfg), ExactStreamDecoder)
    assert isinstance(make_stream_decoder(tparams, cfg, "native"), ExactStreamDecoder)
    windowed = make_stream_decoder(tparams, cfg, "windowed")
    parity = make_stream_decoder(tparams, cfg, "parity")
    assert isinstance(windowed, StreamingSnacDecoder) and windowed.mode == "native"
    assert isinstance(parity, StreamingSnacDecoder) and parity.mode == "parity"
    with pytest.raises(ValueError, match="unknown decoder mode"):
        make_stream_decoder(tparams, cfg, "bogus")
    windowed.push_tokens(list(range(20)))
    windowed.reset()
    assert windowed.frames_buffered == 0 and windowed.push_tokens([1] * 6) == []
