"""Text-to-image engine over the DiT sampler.

The port of ``distributed_gpu_inference_tpu/worker/engines/image_gen.py``:
a seeded DDIM sampler (``models/diffusion.py``, run in f32 on the
engine's device) and base64 PNG output, with the JAX engine's clamps on
steps (1..``max_steps``), images (1..4) and its guidance default. The PNG
is written by the port's own encoder (``utils/png.py``: 8-bit RGB on
``zlib`` + ``struct``), since the card's machine has no Pillow. The first
noise is drawn from a ``torch.Generator`` seeded with the request's seed
(:meth:`ImageGenEngine.initial_noise`), not from JAX's threefry, so one
seed gives other images than the JAX engine. A ``checkpoint_path`` (orbax
in the JAX engine) is refused at load.
"""

from __future__ import annotations

import base64
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .base import BaseEngine, EngineLoadError, engine_device, refuse_orbax


def _png_b64(img_u8: np.ndarray) -> str:
    from ...utils.png import encode_png

    return base64.b64encode(encode_png(img_u8)).decode("ascii")


class ImageGenEngine(BaseEngine):
    """config keys: model (diffusion registry name), default_steps,
    max_steps, guidance_scale, seed (of the weights), device (default
    ``cuda``), params (port-only: a tree already on the device)."""

    task_type = "image_gen"

    def __init__(self, config: Optional[Dict[str, Any]] = None) -> None:
        super().__init__(config)
        self._cfg = None
        self._params = None
        self._tokenizer = None
        self.device: Optional[torch.device] = None

    def load_model(self) -> None:
        from ...models import diffusion
        model = self.config.get("model", "tiny-diffusion")
        try:
            self._cfg = diffusion.get_diffusion_config(model)
        except KeyError as exc:
            raise EngineLoadError(str(exc)) from exc
        refuse_orbax(self.config)
        self.device = engine_device(self.config)
        self._params = self.config.get("params") or diffusion.init_params(
            self._cfg, torch.Generator(device=self.device).manual_seed(
                int(self.config.get("seed", 0))))
        from .llm import ByteTokenizer

        self._tokenizer = ByteTokenizer()
        self.model_name = model
        self.loaded = True

    def initial_noise(self, n: int, seed: int) -> torch.Tensor:
        """The sampler's starting ``x``: a standard normal ``[n, S, S, C]``
        from a generator on the engine's device seeded with ``seed``."""
        c = self._cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn((n, c.image_size, c.image_size, c.channels), generator=gen,
                           device=self.device, dtype=torch.float32)

    @torch.no_grad()
    def inference(self, params: Dict[str, Any]) -> Dict[str, Any]:
        from ...models import diffusion

        if self._params is None:
            raise RuntimeError("model not loaded")
        prompt = str(params.get("prompt", ""))
        # explicit 0 values are honoured: check presence, not truthiness
        steps = int(params["num_inference_steps"]
                    if params.get("num_inference_steps") is not None
                    else self.config.get("default_steps", 20))
        steps = max(1, min(steps, int(self.config.get("max_steps", 250))))
        n = max(1, min(int(params.get("num_images", 1)), 4))
        guidance = float(params["guidance_scale"] if params.get("guidance_scale") is not None
                         else self.config.get("guidance_scale", 3.0))
        seed = params.get("seed")
        seed = int(seed) if seed is not None else int(time.time_ns() % (2**31))

        toks = self._tokenizer.encode(prompt)[: self._cfg.max_text_len]
        tok_arr = torch.zeros((n, self._cfg.max_text_len), dtype=torch.int32)
        tok_arr[:, : len(toks)] = torch.tensor(toks, dtype=torch.int32)

        t0 = time.time()
        imgs = diffusion.ddim_sample(self._cfg, self._params, tok_arr, num_steps=steps,
                                     guidance_scale=guidance,
                                     noise=self.initial_noise(n, seed))
        imgs_u8 = np.asarray(np.clip(imgs.cpu().numpy() * 255.0, 0, 255), np.uint8)
        images: List[str] = [_png_b64(imgs_u8[i]) for i in range(n)]
        return {
            "images": images,
            "format": "png_base64",
            "width": self._cfg.image_size,
            "height": self._cfg.image_size,
            "num_inference_steps": steps,
            "latency_ms": (time.time() - t0) * 1000.0,
            "usage": {"images": n, "pixels": n * self._cfg.image_size**2},
        }

    def unload(self) -> None:
        self._params = None
        self.loaded = False
