"""Wall-clock timing and decode throughput accounting (``Timer`` and
``DecodeStats``, copied from ``jax_llama_tpu/utils/profiling.py``, which
``run.py`` prints).  The profiler wrappers are ROADMAP A16."""

from __future__ import annotations

import dataclasses
import time

import torch


@dataclasses.dataclass
class Timer:
    """Wall-clock timer that waits for queued GPU work on both edges, so
    the measured window covers exactly the enclosed computation."""

    elapsed_s: float = 0.0

    def __enter__(self) -> "Timer":
        _block_on_pending()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        _block_on_pending()
        self.elapsed_s = time.perf_counter() - self._t0


def _block_on_pending() -> None:
    # Only a process that has touched the card has work queued on it.
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclasses.dataclass
class DecodeStats:
    """Throughput accounting for one generation call.

    tokens/sec figures are per device: divided by ``n_devices``."""

    batch: int
    prompt_len: int
    new_tokens: int
    prefill_s: float
    decode_s: float
    n_devices: int = 1

    @property
    def decode_tokens_per_s(self) -> float:
        return self.batch * self.new_tokens / max(self.decode_s, 1e-9)

    @property
    def decode_tokens_per_s_per_chip(self) -> float:
        return self.decode_tokens_per_s / self.n_devices

    @property
    def prefill_tokens_per_s(self) -> float:
        return self.batch * self.prompt_len / max(self.prefill_s, 1e-9)

    @property
    def per_token_latency_ms(self) -> float:
        return 1e3 * self.decode_s / max(self.new_tokens, 1)

    def summary(self) -> str:
        prefill = (
            f"prefill {self.prefill_tokens_per_s:,.0f} tok/s | "
            if self.prefill_s > 0
            else ""
        )
        return (
            f"{prefill}decode "
            f"{self.decode_tokens_per_s_per_chip:,.1f} tok/s/chip "
            f"({self.per_token_latency_ms:.2f} ms/tok, batch {self.batch})"
        )
