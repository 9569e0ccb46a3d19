"""SNAC codec architecture configuration.

Mirrors the hyperparameters of ``hubertsiuzdak/snac_24khz`` (the codec the
reference loads in Morpheus_Client/tts_engine/speechpipe.py:41-43).  The
decoder is a DAC-style stack: RVQ code embeddings are projected to a latent,
then upsampled through transposed-conv blocks with Snake activations,
noise-injection blocks and depthwise residual units.

Pretrained weights are not redistributable here; ``weights.py`` can convert
a torch SNAC checkpoint (folding weight-norm) or initialise randomly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SNACConfig:
    sampling_rate: int = 24000
    encoder_dim: int = 64
    encoder_rates: Tuple[int, ...] = (2, 4, 8, 8)
    decoder_dim: int = 1536
    decoder_rates: Tuple[int, ...] = (8, 8, 4, 2)
    attn_window_size: Optional[int] = None  # 24 kHz model has no local attn
    codebook_size: int = 4096
    codebook_dim: int = 8
    vq_strides: Tuple[int, ...] = (4, 2, 1)  # coarse, medium, fine
    noise: bool = True
    depthwise: bool = True
    latent_dim: Optional[int] = None  # default: encoder_dim * 2**len(rates)

    @property
    def latent(self) -> int:
        if self.latent_dim is not None:
            return self.latent_dim
        return self.encoder_dim * (2 ** len(self.encoder_rates))

    @property
    def hop_length(self) -> int:
        """Samples per fine-codebook step (= product of decoder rates)."""
        return math.prod(self.decoder_rates)

    @property
    def frame_samples(self) -> int:
        """Samples per 7-token Orpheus frame (4 fine codes)."""
        return 4 * self.hop_length

    @classmethod
    def snac_24khz(cls) -> "SNACConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "SNACConfig":
        """Small config for fast hermetic tests (same topology, tiny dims)."""
        return cls(
            sampling_rate=24000,
            encoder_dim=4,
            encoder_rates=(2, 4, 8, 8),
            decoder_dim=32,
            decoder_rates=(8, 8, 4, 2),
            codebook_size=4096,
            codebook_dim=4,
            vq_strides=(4, 2, 1),
            noise=True,
            depthwise=True,
            latent_dim=16,
        )
