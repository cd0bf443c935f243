"""Embedding engine: mean-pooled final hidden states of the decoder.

The port of ``distributed_gpu_inference_tpu/worker/engines/embedding.py``:
one forward over a Llama-family model (``models/llama.py``
``forward_chunk`` with ``with_logits=False``, so no ``[B, S, V]`` head
product is computed and thrown away), the masked mean of the final-norm
hidden states, L2-normalised. Rows of a batch are padded at position -1 to
the longest (at least 8), on KV pools and a table sized to the batch as
in the JAX engine. On the card the pass runs the ragged attention kernel.

``kv_lens`` is zeros, as in the JAX engine, so that one text gets one
vector from either package: every query's context is empty, attention
contributes exact zeros and a text embeds as its bag of tokens ("ab" and
"ba" give one vector). This mirrors a fault of the reference (ROADMAP §3
item 3); a fix belongs to both packages at once.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from .base import BaseEngine, EngineLoadError, engine_device

BLOCK = 16


class EmbeddingEngine(BaseEngine):
    """config keys: model, tokenizer / tokenizer_id, max_seq_len,
    checkpoint_path (an HF safetensors directory), device (default
    ``cuda``), dtype (default the model's), seed, params (a params tree
    already on the device, ``models.convert.params_from_numpy``)."""

    task_type = "embedding"

    def __init__(self, config: Optional[Dict[str, Any]] = None) -> None:
        super().__init__(config)
        self.tokenizer = self.config.get("tokenizer")
        self._params = None
        self._cfg = None
        self.device: Optional[torch.device] = None

    def load_model(self) -> None:
        from ...models import llama
        from ...models.configs import get_model_config
        from ...models.loader import load_or_init_params
        from ...runtime.engine import check_kernels_take

        try:
            self._cfg = get_model_config(self.config.get("model", "llama3-mini"))
            self.device = engine_device(self.config)
            self._dtype = llama.torch_dtype(self.config.get("dtype") or self._cfg.dtype)
            if self.device.type == "cuda":
                check_kernels_take(self._cfg, self._dtype, self._dtype)
            self._params = self.config.get("params") or load_or_init_params(
                self._cfg, self.config.get("checkpoint_path"), dtype=self._dtype,
                seed=int(self.config.get("seed", 0)), device=self.device)
        except (KeyError, ValueError, OSError) as exc:
            raise EngineLoadError(str(exc)) from exc
        if self.tokenizer is None:
            from .llm import ByteTokenizer, _load_hf_tokenizer

            tok_id = self.config.get("tokenizer_id")
            self.tokenizer = _load_hf_tokenizer(tok_id) if tok_id else ByteTokenizer()
        self._max_len = int(self.config.get("max_seq_len", 512))
        self.loaded = True

    def unload(self) -> None:
        self._params = None
        super().unload()

    @torch.no_grad()
    def embed(self, ids: List[List[int]]) -> torch.Tensor:
        """Token rows (at least one token each) → ``[B, H]`` f32 unit
        vectors on the device."""
        from ...models import llama

        cfg, dev = self._cfg, self.device
        lengths = torch.tensor([len(r) for r in ids], dtype=torch.int32)
        b, s = len(ids), max(8, int(lengths.max()))
        batch = torch.zeros((b, s), dtype=torch.int32)
        for r, seq in enumerate(ids):
            batch[r, : len(seq)] = torch.tensor(seq, dtype=torch.int32)
        valid = torch.arange(s)[None, :] < lengths[:, None]
        positions = torch.where(valid, torch.arange(s, dtype=torch.int32)[None, :], -1)
        m = -(-s // BLOCK)
        kv = llama.init_kv_pools(cfg, 1 + b * m, BLOCK, self._dtype, dev)
        tables = (1 + torch.arange(b * m, dtype=torch.int32)).reshape(b, m)
        out = llama.forward_chunk(
            cfg, self._params, batch.to(dev), positions.to(dev), kv, tables.to(dev),
            torch.zeros((b,), dtype=torch.int32, device=dev), block_size=BLOCK,
            with_logits=False,
        )
        hidden = llama.rms_norm(out.hidden, self._params["final_norm"], cfg.rms_norm_eps,
                                cfg.norm_offset).float()
        mask = valid.to(dev)[..., None].float()
        pooled = (hidden * mask).sum(1) / torch.clamp(mask.sum(1), min=1.0)
        return pooled / torch.clamp(torch.linalg.norm(pooled, dim=-1, keepdim=True), min=1e-9)

    def inference(self, params: Dict[str, Any]) -> Dict[str, Any]:
        if not self.loaded:
            raise EngineLoadError("engine not loaded")
        texts = params.get("texts")
        if texts is None:
            texts = [params.get("text") or params.get("prompt") or ""]
        # an empty text embeds as one pad token (id 0), as in the JAX engine
        ids = [list(self.tokenizer.encode(t))[: self._max_len] or [0] for t in texts]
        out = self.embed(ids).cpu().numpy()
        total = int(sum(len(r) for r in ids))
        return {
            "embeddings": out.tolist(),
            "dim": int(out.shape[-1]),
            "usage": {"prompt_tokens": total, "total_tokens": total},
        }

