"""ASR model: log-mel frontend + transformer encoder + CTC head.

The port of ``distributed_gpu_inference_tpu/models/asr.py``. Fixed-length
audio becomes a fixed-shape log-mel on the host (numpy, copied from the
JAX package as it is), one encoder pass on the device gives CTC logits,
and a greedy collapse on the host gives the ids. No autoregressive loop
and no KV cache.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np
import torch

from distributed_gpu_inference_torch.models.encoder_common import (
    fan_in_init,
    init_encoder_layers,
    layer_norm,
    run_encoder,
)

Params = Dict[str, Any]

CTC_BLANK = 0


@dataclass(frozen=True)
class ASRConfig:
    name: str = "tiny-whisper"
    sample_rate: int = 16000
    n_fft: int = 400
    hop: int = 160
    n_mels: int = 40
    max_seconds: float = 4.0
    hidden_size: int = 96
    num_layers: int = 4
    num_heads: int = 4
    vocab_size: int = 260          # byte tokenizer vocab (blank = 0)
    conv_stride: int = 4           # time downsampling before the encoder

    @property
    def max_samples(self) -> int:
        return int(self.sample_rate * self.max_seconds)

    @property
    def num_frames(self) -> int:
        return self.max_samples // self.hop

    @property
    def enc_frames(self) -> int:
        return self.num_frames // self.conv_stride


ASR_REGISTRY: Dict[str, ASRConfig] = {
    "tiny-whisper": ASRConfig(),
    "small-whisper": ASRConfig(
        name="small-whisper", max_seconds=30.0, n_mels=80,
        hidden_size=384, num_layers=12, num_heads=6,
    ),
}


def get_asr_config(name: str) -> ASRConfig:
    if name not in ASR_REGISTRY:
        raise KeyError(f"unknown asr model {name!r}")
    return ASR_REGISTRY[name]


# ---------------------------------------------------------------------------
# mel frontend (host numpy)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _mel_filterbank(cfg: ASRConfig) -> np.ndarray:
    n_bins = cfg.n_fft // 2 + 1
    f_max = cfg.sample_rate / 2

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mels = np.linspace(0.0, hz_to_mel(f_max), cfg.n_mels + 2)
    freqs = mel_to_hz(mels)
    bins = np.floor((cfg.n_fft + 1) * freqs / cfg.sample_rate).astype(int)
    fb = np.zeros((cfg.n_mels, n_bins), np.float32)
    for m in range(1, cfg.n_mels + 1):
        lo, ctr, hi = bins[m - 1], bins[m], bins[m + 1]
        for k in range(lo, ctr):
            if ctr > lo:
                fb[m - 1, k] = (k - lo) / (ctr - lo)
        for k in range(ctr, hi):
            if hi > ctr:
                fb[m - 1, k] = (hi - k) / (hi - ctr)
    return fb


def log_mel(cfg: ASRConfig, audio: np.ndarray) -> np.ndarray:
    """[B, max_samples] f32 PCM in [-1,1] → [B, num_frames, n_mels]."""
    window = np.hanning(cfg.n_fft).astype(np.float32)
    padded = np.pad(audio, ((0, 0), (0, cfg.n_fft)))
    all_frames = np.lib.stride_tricks.sliding_window_view(padded, cfg.n_fft, axis=1)
    frames = all_frames[:, :: cfg.hop][:, : cfg.num_frames] * window
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    mel = spec @ _mel_filterbank(cfg).T
    return np.log10(np.maximum(mel, 1e-10)).astype(np.float32)


# ---------------------------------------------------------------------------
# encoder + CTC
# ---------------------------------------------------------------------------


def init_params(cfg: ASRConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32) -> Params:
    """Random init on the generator's device (not JAX's threefry draws)."""
    h = cfg.hidden_size
    in_dim = cfg.n_mels * cfg.conv_stride
    return {
        "in_proj": fan_in_init(generator, (in_dim, h), in_dim, dtype),
        "pos_emb": fan_in_init(generator, (cfg.enc_frames, h), h, dtype),
        "layers": init_encoder_layers(generator, cfg.num_layers, h, dtype=dtype),
        "out_norm": torch.ones((h,), dtype=dtype, device=generator.device),
        "ctc_head": fan_in_init(generator, (h, cfg.vocab_size), h, dtype),
    }


def encode(cfg: ASRConfig, params: Params, mel: torch.Tensor) -> torch.Tensor:
    """[B, num_frames, n_mels] → CTC logits [B, enc_frames, vocab]."""
    b = mel.shape[0]
    # stride-fold time downsampling (conv-free "conv subsampling")
    x = mel.reshape(b, cfg.enc_frames, cfg.n_mels * cfg.conv_stride)
    x = x @ params["in_proj"] + params["pos_emb"][None]
    x = run_encoder(x, params["layers"], cfg.num_heads)
    return layer_norm(x, params["out_norm"]) @ params["ctc_head"]


def ctc_greedy_decode(logits: np.ndarray) -> List[List[int]]:
    """Greedy CTC collapse: argmax per frame, merge repeats, drop blanks."""
    ids = np.argmax(logits, axis=-1)
    out: List[List[int]] = []
    for row in ids:
        seq: List[int] = []
        prev = -1
        for t in row:
            t = int(t)
            if t != prev and t != CTC_BLANK:
                seq.append(t)
            prev = t
        out.append(seq)
    return out
