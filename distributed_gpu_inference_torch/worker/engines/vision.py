"""Vision-language engine: a ViT soft-token prefix into the Llama decoder.

The port of ``distributed_gpu_inference_tpu/worker/engines/vision.py``:
tasks image_qa / caption / ocr, a base64 ``image`` or nested-list
``pixels`` input. ``models/vit.py`` encodes the image to ``num_prefix``
soft tokens, which enter the decoder as a hidden-state prefix through
``llama.forward_hidden_chunk``; the question pads to ``max_text_len`` at
positions -1 (their KV writes are dropped), so every prefill has one
shape. The answer decodes greedily, a token a step (S = 1), on KV pools
allocated once at load with a one-row table.

Dtypes. The JAX engine runs the decoder and its pools in f32. The CUDA
attention kernels take bf16 activations only (``ops/paged_attention.py``
``kernel_takes``), so on the card the decoder and pools default to bf16
(the ViT stays f32 and its prefix is cast), and an explicit ``dtype:
float32`` there is refused at load; on the CPU the decoder is f32 as in
JAX. On the card the prefill runs the ragged kernel and each decode step
the fused decode kernel.

Images. The JAX engine reads every image through Pillow
(``Image.open(f).convert("RGB")``, then ``Image.resize`` to the ViT's
geometry); the card's machine has no Pillow, so the port does both
itself, bit for bit as Pillow 12.1.0 does: a PNG (told by its signature)
through ``utils/png.py``, a JPEG through ``utils/jpeg.py``, and every
resize through ``utils/resize.py`` (Pillow's bicubic). These run in C++
on the host (``native/src/image_codec.cpp``), or in their plain numpy
versions with a logged warning where no compiler exists. Pillow is never a
fallback for a PNG or a JPEG: a JPEG the reader refuses fails the request
with the words of ``utils/jpeg.py``'s ``JPEGUnsupported``. Only other formats
(GIF, BMP, WebP, TIFF) go through Pillow, imported on first use; where
Pillow is missing such a request fails with a ``ValueError`` that says
so. Either way the engine stays up.
"""

from __future__ import annotations

import base64
import io
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .base import BaseEngine, EngineLoadError, engine_device

_TASK_PROMPTS = {
    "image_qa": "Answer the question about the image: ",
    "caption": "Describe the image: ",
    "ocr": "Transcribe all text in the image: ",
}


def _pillow():
    try:
        from PIL import Image
    except ImportError as exc:
        raise ValueError(
            "this image format needs Pillow (the port reads PNG and JPEG itself), and "
            "Pillow is not installed") from exc
    return Image


def _decode_image(params: Dict[str, Any], size: int) -> np.ndarray:
    """base64 ``image`` or nested-list ``pixels`` → [H, W, 3] float32 in
    [0, 1], resized to the model geometry."""
    from ...utils.jpeg import decode_jpeg, is_jpeg
    from ...utils.png import SIGNATURE, decode_png
    from ...utils.resize import resize_bicubic

    u8 = None
    if "pixels" in params:
        arr = np.asarray(params["pixels"], np.float32)
        if arr.ndim != 3 or arr.shape[-1] != 3:
            raise ValueError("pixels must be [H, W, 3]")
    elif "image" in params:
        raw = base64.b64decode(params["image"])
        if raw.startswith(SIGNATURE):
            u8 = decode_png(raw)
        elif is_jpeg(raw):
            u8 = decode_jpeg(raw)
        else:
            u8 = np.asarray(_pillow().open(io.BytesIO(raw)).convert("RGB"))
    else:
        raise ValueError("provide 'image' (base64) or 'pixels'")
    if u8 is None and (arr.shape[0] != size or arr.shape[1] != size):
        # as the JAX engine: to uint8, resize, back to [0, 1]
        u8 = np.asarray(np.clip(arr * 255, 0, 255), np.uint8)
    if u8 is not None:
        # a decoded image resizes as it is: the JAX engine's trip through
        # float32 [0, 1] and back gives every uint8 value back exactly
        if u8.shape[0] != size or u8.shape[1] != size:
            u8 = resize_bicubic(u8, (size, size))
        arr = u8.astype(np.float32) / 255.0
    return np.clip(arr, 0.0, 1.0)


class VisionEngine(BaseEngine):
    """config keys: model (llama registry), vit_model, max_new_tokens,
    max_text_len, max_new_cap, tokenizer / tokenizer_id, checkpoint_path
    (the decoder's HF directory), vit_checkpoint_path (an HF ViT
    directory), device (default ``cuda``), dtype (the decoder's: default
    bf16 on the card, f32 on the CPU), seed, and the port-only ``params``
    / ``vit_params`` (trees already on the device)."""

    task_type = "vision"

    def __init__(self, config: Optional[Dict[str, Any]] = None) -> None:
        super().__init__(config)
        self._llm_cfg = None
        self._llm_params = None
        self._vit_cfg = None
        self._vit_params = None
        self._tokenizer = None
        self._kv = None
        self.device: Optional[torch.device] = None

    def load_model(self) -> None:
        from ...models import llama, vit
        from ...models.configs import get_model_config
        from ...models.loader import load_hf_vit, load_or_init_params
        from ...ops.paged_attention import kernel_takes

        llm_name = self.config.get("model", "llama3-tiny")
        vit_name = self.config.get("vit_model", "tiny-vit")
        try:
            self._llm_cfg = get_model_config(llm_name)
            self._vit_cfg = vit.get_vit_config(vit_name)
        except KeyError as exc:
            raise EngineLoadError(str(exc)) from exc
        if self._vit_cfg.out_dim != self._llm_cfg.hidden_size:
            raise EngineLoadError(
                f"vit out_dim {self._vit_cfg.out_dim} != decoder hidden "
                f"{self._llm_cfg.hidden_size}")
        self.device = dev = engine_device(self.config)
        on_card = dev.type == "cuda"
        self._dtype = llama.torch_dtype(
            self.config.get("dtype") or ("bfloat16" if on_card else "float32"))
        if on_card and not kernel_takes(self._llm_cfg.head_dim, self._dtype, self._dtype):
            raise EngineLoadError(
                f"vision decoder dtype {self._dtype} / head_dim {self._llm_cfg.head_dim}: "
                "on the card the decoder runs the CUDA attention kernels, which take bf16 "
                "activations and head_dim 32/64/128/256 (the JAX engine's f32 decoder is "
                "served in bf16 here; leave dtype unset or set bfloat16)")
        try:
            self._llm_params = self.config.get("params") or load_or_init_params(
                self._llm_cfg, self.config.get("checkpoint_path"), dtype=self._dtype,
                seed=int(self.config.get("seed", 0)), device=dev)
            if self.config.get("vit_params") is not None:
                self._vit_params = self.config["vit_params"]
            elif self.config.get("vit_checkpoint_path"):
                # a pretrained HF ViT encoder; the resampler head is fresh
                self._vit_params = load_hf_vit(self.config["vit_checkpoint_path"],
                                               self._vit_cfg, device=dev)
            else:
                self._vit_params = vit.init_params(
                    self._vit_cfg, torch.Generator(device=dev).manual_seed(7))
        except (ValueError, OSError) as exc:
            raise EngineLoadError(str(exc)) from exc
        tok = self.config.get("tokenizer")
        if tok is None:
            from .llm import ByteTokenizer, _load_hf_tokenizer

            tok_id = self.config.get("tokenizer_id")
            tok = _load_hf_tokenizer(tok_id) if tok_id else ByteTokenizer()
        self._tokenizer = tok
        self.model_name = f"{vit_name}+{llm_name}"
        # one prefill shape and one decode shape serve every request: the
        # question pads to max_text_len, and the pools are allocated once
        self._block = 16
        self._max_text = int(self.config.get("max_text_len", 64))
        self._max_new_cap = int(self.config.get("max_new_cap", 64))
        total = self._vit_cfg.num_prefix + self._max_text + self._max_new_cap
        self._max_blocks = -(-total // self._block) + 1
        self._kv = llama.init_kv_pools(self._llm_cfg, self._max_blocks + 2, self._block,
                                       self._dtype, dev)
        self._table = torch.arange(1, self._max_blocks + 1, dtype=torch.int32,
                                   device=dev)[None]
        self.loaded = True

    # -- the two device steps ------------------------------------------------

    def prefill(self, image: np.ndarray, toks: List[int]) -> torch.Tensor:
        """The ViT prefix and the padded question through the decoder →
        the logits ``[V]`` (f32) after the question's last token."""
        from ...models import llama, vit

        cfg, dev = self._llm_cfg, self.device
        n_prefix = self._vit_cfg.num_prefix
        seq = n_prefix + len(toks)
        tok_pad = torch.zeros((1, self._max_text), dtype=torch.int32)
        tok_pad[0, : len(toks)] = torch.tensor(toks, dtype=torch.int32)
        positions = torch.full((1, n_prefix + self._max_text), -1, dtype=torch.int32)
        positions[0, :seq] = torch.arange(seq, dtype=torch.int32)
        prefix = vit.encode_image(self._vit_cfg, self._vit_params,
                                  torch.from_numpy(image[None]).to(dev))
        text = llama.embed_tokens(self._llm_params, tok_pad.to(dev), cfg)
        hidden = torch.cat([prefix.to(text.dtype), text], dim=1)
        hidden, _ = llama.forward_hidden_chunk(
            cfg, self._llm_params, hidden, positions.to(dev), self._kv, self._table,
            torch.tensor([seq], dtype=torch.int32, device=dev), block_size=self._block)
        return llama.project_logits(cfg, self._llm_params, hidden[:, seq - 1:seq])[0, 0]

    def decode(self, tok: int, kv_len: int) -> torch.Tensor:
        """One greedy step: ``tok`` at position ``kv_len - 1`` → logits [V]."""
        from ...models import llama

        dev = self.device
        out = llama.forward_chunk(
            self._llm_cfg, self._llm_params,
            torch.tensor([[tok]], dtype=torch.int32, device=dev),
            torch.tensor([[kv_len - 1]], dtype=torch.int32, device=dev), self._kv,
            self._table, torch.tensor([kv_len], dtype=torch.int32, device=dev),
            block_size=self._block, last_only=True)
        return out.logits[0, 0]

    @torch.no_grad()
    def inference(self, params: Dict[str, Any]) -> Dict[str, Any]:
        if self._llm_params is None:
            raise RuntimeError("model not loaded")
        t0 = time.time()
        task = params.get("task", "image_qa")
        if task not in _TASK_PROMPTS:
            raise ValueError(f"unknown vision task {task!r}; known: {sorted(_TASK_PROMPTS)}")
        image = _decode_image(params, self._vit_cfg.image_size)
        question = str(params.get("question") or params.get("prompt") or "")
        toks = self._tokenizer.encode(_TASK_PROMPTS[task] + question)[: self._max_text]
        max_new = int(params["max_new_tokens"] if params.get("max_new_tokens") is not None
                      else self.config.get("max_new_tokens", 32))
        max_new = max(1, min(max_new, self._max_new_cap))
        n_prefix = self._vit_cfg.num_prefix
        kv_len = n_prefix + len(toks)
        tok = int(torch.argmax(self.prefill(image, toks)).item())
        eos = getattr(self._tokenizer, "eos_token_id", None)
        out_ids: List[int] = []
        while tok != eos:
            out_ids.append(tok)
            if len(out_ids) >= max_new:
                break           # budget reached: no forward whose token is dropped
            kv_len += 1
            tok = int(torch.argmax(self.decode(tok, kv_len)).item())
        return {
            "text": self._tokenizer.decode(out_ids),
            "task": task,
            "usage": {
                "prompt_tokens": len(toks) + n_prefix,
                "completion_tokens": len(out_ids),
                "total_tokens": len(toks) + n_prefix + len(out_ids),
            },
            "latency_ms": (time.time() - t0) * 1000.0,
        }

    def unload(self) -> None:
        self._llm_params = None
        self._vit_params = None
        self._kv = None
        self.loaded = False
