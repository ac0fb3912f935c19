"""High-level generation API (port of ``jax_llama_tpu/generation.py``):
tokenize with BOS, left-pad to a power-of-two bucket, generate, strip
padding and cut at the first stop token."""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from .config import LLaMAConfig
from .engine import GenerationConfig, generate as engine_generate, next_pow2
from .models.llama import resolve_device


@dataclasses.dataclass
class LLaMA:
    """Params + config + tokenizer, on ``device`` ("cuda" by default; it
    raises when no GPU is present unless ``device="cpu"``).  ``mesh``: a
    ``parallel.Mesh`` when ``params`` is this rank's shard; every rank
    then calls the same methods with the same arguments (JAX :40)."""

    params: Any
    config: LLaMAConfig
    tokenizer: Any
    device: Any = "cuda"
    mesh: Optional[Any] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _pad_id(self) -> int:
        pad = getattr(self.tokenizer, "pad_id", -1)
        if pad is None or pad < 0:
            pad = self.tokenizer.eos_id
        return pad

    def _stop_tokens(self) -> tuple:
        stops = getattr(self.tokenizer, "stop_tokens", None)
        if stops is None:
            stops = [self.tokenizer.eos_id]
        return tuple(int(s) for s in stops)

    def generate(
        self,
        tokens,
        attn_mask,
        max_gen_len: int,
        temperature: float = 0.8,
        top_p: float = 0.95,
        seed: int = 0,
    ) -> np.ndarray:
        """Token-level generation on left-padded [B, P] input."""
        gen_config = GenerationConfig(
            max_new_tokens=max_gen_len,
            temperature=temperature,
            top_p=top_p,
            stop_tokens=self._stop_tokens(),
            pad_id=self._pad_id(),
        )
        generator = torch.Generator(device=self.device).manual_seed(seed)
        out = engine_generate(
            self.params,
            torch.as_tensor(np.asarray(tokens), dtype=torch.int32),
            torch.as_tensor(np.asarray(attn_mask), dtype=torch.bool),
            generator,
            config=self.config,
            gen_config=gen_config,
            device=self.device,
            mesh=self.mesh,
        )
        return out.cpu().numpy()

    def generate_from_str(
        self,
        prompts: Sequence[str],
        max_gen_len: int,
        temperature: float = 0.8,
        top_p: float = 0.95,
        seed: int = 0,
    ) -> List[str]:
        """Encode (with BOS), left-pad, generate, decode."""
        if not prompts:
            raise ValueError("prompts must be a non-empty sequence of strings")
        encoded = [
            self.tokenizer.encode(p, bos=True, eos=False) for p in prompts
        ]
        max_len = next_pow2(max(len(e) for e in encoded))
        pad = self._pad_id()
        B = len(encoded)
        tokens = np.full((B, max_len), pad, dtype=np.int32)
        mask = np.zeros((B, max_len), dtype=bool)
        for i, e in enumerate(encoded):
            tokens[i, max_len - len(e):] = e
            mask[i, max_len - len(e):] = True

        out = self.generate(tokens, mask, max_gen_len, temperature, top_p, seed)

        stops = set(self._stop_tokens())
        results = []
        for i in range(B):
            ids: List[int] = []
            for t in out[i, max_len:].tolist():
                if t in stops or t == pad:
                    break
                ids.append(t)
            results.append(self.tokenizer.decode(ids))
        return results
