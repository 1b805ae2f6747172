"""Batched serving engine: prefill, then a decode loop over a preallocated
KV cache (port of ``repro.serve.engine``).

Requests are bucketed into waves by prompt length.  A wave's caches are
allocated once at their full length (prompt plus new tokens) and written in
place, by prefill and by every decode step; the JAX engine pads its
immutable caches after prefill instead (``_pad_caches``), which a mutable
tensor does not need.  Greedy sampling is an argmax (first index on ties,
as ``jnp.argmax``); temperature sampling is the Gumbel-max draw of
``jax.random.categorical`` from a ``torch.Generator`` seeded by ``seed``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None


class ServeEngine:
    """Greedy/temperature decoding over a :class:`DecoderLM` of any
    decoder-only family; an encoder-decoder model is refused, as the JAX
    engine refuses it (serve it with ``EncDecLM.greedy``).

    ``use_kernel`` goes to prefill attention (``False``: the plain version
    on the card too, for comparison).  ``stats`` collects one record per
    wave: batch, prompt length, prefill and decode seconds, decode steps.
    """

    def __init__(self, model, *, temperature: float = 0.0, seed: int = 0,
                 use_kernel="auto"):
        if model.cfg.is_encdec:
            raise NotImplementedError(
                "ServeEngine drives decoder-only families; serve an encoder-decoder "
                "model with EncDecLM.prefill / serve_step (EncDecLM.greedy)")
        self.model = model
        self.temperature = temperature
        self.use_kernel = use_kernel
        self._gen = torch.Generator(device=model.device).manual_seed(seed)
        self.stats: list = []

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        u = torch.rand(logits.shape, generator=self._gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits.to(torch.float32) / self.temperature + gumbel, dim=-1)

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def generate_wave(self, prompts: np.ndarray, max_new_tokens: int,
                      eos_id: Optional[int] = None) -> np.ndarray:
        """prompts (B, S) int, one length -> (B, max_new_tokens) int32."""
        b, s = prompts.shape
        cfg = self.model.cfg
        if cfg.family in ("ssm", "hybrid") and max_new_tokens > 1 and s < cfg.ssm_conv - 1:
            # The prefill's conv cache keeps the prompt's last ssm_conv - 1
            # inputs; a shorter prompt leaves it short and decoding fails.
            raise ValueError(f"a prompt of {s} tokens is shorter than the SSM conv "
                             f"window's {cfg.ssm_conv - 1}-token cache: decoding needs it")
        clock = time.perf_counter
        t0 = clock()
        tokens = torch.as_tensor(np.asarray(prompts, np.int64), device=self.model.device)
        last, caches = self.model.prefill(tokens, cache_len=s + max_new_tokens,
                                          use_kernel=self.use_kernel)
        next_tok = self._sample(last)
        self._sync()
        t1 = clock()
        out = np.zeros((b, max_new_tokens), np.int32)
        done = np.zeros((b,), bool)
        steps = 0
        for i in range(max_new_tokens):
            out[:, i] = np.where(done, eos_id or 0, next_tok.cpu().numpy())
            if eos_id is not None:
                done |= out[:, i] == eos_id
                if done.all():
                    break
            if i == max_new_tokens - 1:
                break  # the JAX engine's last step computes logits it discards
            logits, caches = self.model.serve_step(next_tok[:, None], s + i, caches)
            next_tok = self._sample(logits[:, 0])
            steps += 1
        self._sync()
        self.stats.append(dict(batch=b, prompt_len=s, prefill_s=t1 - t0,
                               decode_s=clock() - t1, decode_steps=steps))
        return out

    def serve(self, requests: List[Request]) -> List[List[int]]:
        """Bucket by prompt length, run the waves, return new tokens per request."""
        order = sorted(range(len(requests)), key=lambda i: len(requests[i].prompt))
        results: dict = {}
        i = 0
        while i < len(order):
            j = i
            plen = len(requests[order[i]].prompt)
            while j < len(order) and len(requests[order[j]].prompt) == plen:
                j += 1
            wave_ids = order[i:j]
            wave = np.stack([np.asarray(requests[k].prompt, np.int64) for k in wave_ids])
            mnt = max(requests[k].max_new_tokens for k in wave_ids)
            toks = self.generate_wave(wave, mnt, requests[wave_ids[0]].eos_id)
            for row, k in enumerate(wave_ids):
                t = toks[row, : requests[k].max_new_tokens].tolist()
                if requests[k].eos_id is not None and requests[k].eos_id in t:
                    t = t[: t.index(requests[k].eos_id)]
                results[k] = t
            i = j
        return [results[k] for k in range(len(requests))]
