"""Modality frontend stubs: a NumPy copy of the JAX package's
``models/frontends.py``, with the same seeded arrays.

The ``[vlm]`` and ``[audio]`` architectures specify the transformer
backbone; the vision encoder (ViT/SigLIP + projector, anyres tiling) and the
audio codec (mel-spectrogram + conv downsampler) are stubs that emit
embeddings of the right shape, seeded and deterministic so that tests and
runs are reproducible.

Shapes follow the real frontends:
  llava-next anyres  — base 576 patch tokens (24x24) + up to 4 tiles;
                       text tokens interleave after the image block.
  whisper            — 30 s of 16 kHz audio -> 3000 mel frames -> conv
                       stride 2 -> 1500 frame embeddings.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.registry import ModelConfig

VLM_BASE_PATCHES = 576          # 24 x 24 @ 336px, CLIP-L/14
WHISPER_FRAMES = 1500           # 30 s -> 1500 post-conv frames


def vision_embeddings(cfg: ModelConfig, batch: int, *, tiles: int = 1, seed: int = 0,
                      dtype=np.float32) -> np.ndarray:
    """(B, tiles*576, d_model) patch embeddings — the projector output."""
    if cfg.frontend != "vision":
        raise ValueError(f"{cfg.name} has no vision frontend")
    rng = np.random.default_rng(seed)
    n = VLM_BASE_PATCHES * max(1, tiles)
    # unit-RMS embeddings, matching the projector's layernormed output
    x = rng.standard_normal((batch, n, cfg.d_model)).astype(dtype)
    return x / np.sqrt(cfg.d_model)


def multimodal_inputs(cfg: ModelConfig, text_tokens: np.ndarray, text_embed: np.ndarray, *,
                      tiles: int = 1, seed: int = 0) -> np.ndarray:
    """Interleave [image patches; text] -> (B, S_img+S_text, d_model);
    ``text_tokens`` (B, S_text) int, ``text_embed`` the (vocab, d) table."""
    img = vision_embeddings(cfg, text_tokens.shape[0], tiles=tiles, seed=seed)
    txt = np.asarray(text_embed)[text_tokens]           # (B, S_text, d)
    return np.concatenate([img, txt.astype(img.dtype)], axis=1)


def audio_frames(cfg: ModelConfig, batch: int, *, frames: int = 0, seed: int = 0,
                 dtype=np.float32) -> np.ndarray:
    """(B, frames, d_model) post-conv mel-frame embeddings; ``frames`` 0
    takes the config's encoder length (at most 1500)."""
    if cfg.frontend != "audio":
        raise ValueError(f"{cfg.name} has no audio frontend")
    rng = np.random.default_rng(seed)
    n = frames or min(cfg.encoder_seq, WHISPER_FRAMES)
    x = rng.standard_normal((batch, n, cfg.d_model)).astype(dtype)
    return x / np.sqrt(cfg.d_model)
