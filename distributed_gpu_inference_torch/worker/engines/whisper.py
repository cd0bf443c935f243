"""ASR engine: log-mel → CTC encoder → greedy collapse → text.

The port of ``distributed_gpu_inference_tpu/worker/engines/whisper.py``.
Audio arrives as base64 WAV (read with the standard library's ``wave``),
base64 raw float32 PCM (``audio_format: pcm_f32``) or a list of
``samples``, 16 kHz mono; nothing is resampled. The clip pads or
truncates to the model's window (a truncated clip is reported as such),
the log-mel is computed on the host (``models/asr.py``), the encoder runs
in f32 on the engine's device and the CTC collapse on the host. A
``checkpoint_path`` (an orbax directory in the JAX engine) is refused at
load: orbax is JAX-only.
"""

from __future__ import annotations

import base64
import io
import time
import wave
from typing import Any, Dict, Optional

import numpy as np
import torch

from .base import BaseEngine, EngineLoadError, engine_device, refuse_orbax


def _decode_audio(params: Dict[str, Any], sample_rate: int) -> np.ndarray:
    """→ float32 PCM in [-1, 1], mono."""
    if "samples" in params:
        return np.asarray(params["samples"], np.float32)
    fmt = params.get("audio_format", "wav")
    if "audio" not in params:
        raise ValueError("provide 'audio' (base64) or 'samples'")
    raw = base64.b64decode(params["audio"])
    if fmt == "pcm_f32":
        return np.frombuffer(raw, np.float32).copy()
    with wave.open(io.BytesIO(raw), "rb") as w:
        if w.getframerate() != sample_rate:
            raise ValueError(f"expected {sample_rate} Hz audio, got {w.getframerate()}")
        data = w.readframes(w.getnframes())
        width = w.getsampwidth()
        if width == 2:
            pcm = np.frombuffer(data, np.int16).astype(np.float32) / 32768.0
        elif width == 4:
            pcm = np.frombuffer(data, np.int32).astype(np.float32) / 2**31
        else:
            raise ValueError(f"unsupported sample width {width}")
        if w.getnchannels() > 1:
            pcm = pcm.reshape(-1, w.getnchannels()).mean(axis=1)
        return pcm


class WhisperEngine(BaseEngine):
    """config keys: model (asr registry name), seed, device (default
    ``cuda``), params (port-only: a tree already on the device)."""

    task_type = "whisper"

    def __init__(self, config: Optional[Dict[str, Any]] = None) -> None:
        super().__init__(config)
        self._cfg = None
        self._params = None
        self._tokenizer = None
        self.device: Optional[torch.device] = None

    def load_model(self) -> None:
        from ...models import asr
        model = self.config.get("model", "tiny-whisper")
        try:
            self._cfg = asr.get_asr_config(model)
        except KeyError as exc:
            raise EngineLoadError(str(exc)) from exc
        refuse_orbax(self.config)
        self.device = engine_device(self.config)
        self._params = self.config.get("params") or asr.init_params(
            self._cfg, torch.Generator(device=self.device).manual_seed(
                int(self.config.get("seed", 0))))
        from .llm import ByteTokenizer

        self._tokenizer = ByteTokenizer()
        self.model_name = model
        self.loaded = True

    @torch.no_grad()
    def logits(self, pcm: np.ndarray) -> np.ndarray:
        """A clip of exactly ``max_samples`` → CTC logits [enc_frames, vocab]."""
        from ...models import asr

        mel = torch.from_numpy(asr.log_mel(self._cfg, pcm[None, :])).to(self.device)
        return asr.encode(self._cfg, self._params, mel)[0].cpu().numpy()

    def inference(self, params: Dict[str, Any]) -> Dict[str, Any]:
        from ...models import asr

        if self._params is None:
            raise RuntimeError("model not loaded")
        t0 = time.time()
        pcm = _decode_audio(params, self._cfg.sample_rate)
        duration_s = len(pcm) / self._cfg.sample_rate
        # fixed-shape window: pad or truncate to the model's horizon; a
        # truncated clip is reported (and billed) as such, never silently
        n = self._cfg.max_samples
        truncated = len(pcm) > n
        transcribed_s = min(duration_s, self._cfg.max_seconds)
        pcm = pcm[:n] if truncated else np.pad(pcm, (0, n - len(pcm)))
        ids = asr.ctc_greedy_decode(self.logits(pcm)[None])[0]
        return {
            "text": self._tokenizer.decode(ids),
            "language": params.get("language", "en"),
            "duration_seconds": duration_s,
            "transcribed_seconds": transcribed_s,
            "truncated": truncated,
            "usage": {"audio_seconds": transcribed_s},
            "latency_ms": (time.time() - t0) * 1000.0,
        }

    def unload(self) -> None:
        self._params = None
        self.loaded = False
