"""Deterministic, resumable synthetic data pipeline (counterpart of
``repro/data/pipeline.py``).

Batches are keyed only by (seed, step): a counter-based pipeline, so
``from_state(state_dict())`` resumes the exact token stream. The text path
is the JAX package's numpy code, so its tokens are bit-identical to JAX's
for every (seed, step); batches are host numpy arrays, moved to the card by
the caller.

Synthetic text: Zipf-distributed unigrams with short repeated motifs, so
the LM loss has learnable structure. Frontend configs draw their random
patch or frame embeddings from the same stream, in JAX's order.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np

from repro_torch.config import ModelConfig
from repro_torch.models.frontends import FRONTEND_DIM


def make_batch_specs(model_cfg: ModelConfig, batch: int, seq: int
                     ) -> Dict[str, Any]:
    """Shape and numpy dtype of each array of one batch."""
    if model_cfg.frontend == "audio_frames":
        return {
            "frames": ((batch, seq, model_cfg.d_model), np.float32),
            "targets": ((batch, seq), np.int32),
            "mask": ((batch, seq), np.bool_),
        }
    spec: Dict[str, Any] = {"tokens": ((batch, seq), np.int32)}
    if model_cfg.frontend == "vision_patches":
        spec["patches"] = ((batch, model_cfg.frontend_tokens, FRONTEND_DIM),
                           np.float32)
    return spec


class DataPipeline:
    def __init__(self, model_cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0, start_step: int = 0):
        self.model_cfg = model_cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.step = start_step
        self._vocab = model_cfg.vocab_size

    # ----- persistence -----
    def state_dict(self) -> Dict[str, int]:
        return {"seed": self.seed, "data_step": self.step}

    @classmethod
    def from_state(cls, model_cfg: ModelConfig, batch: int, seq: int,
                   state: Dict[str, int]) -> "DataPipeline":
        return cls(model_cfg, batch, seq, seed=state["seed"],
                   start_step=state["data_step"])

    # ----- generation -----
    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))

    def _tokens(self, rng: np.random.Generator, shape) -> np.ndarray:
        v = self._vocab
        z = rng.zipf(1.3, size=shape).astype(np.int64)
        out = ((z - 1) % v).reshape(shape)
        # inject repeated motifs: with p=.5 copy the previous 8-token window
        B, S = shape
        for b in range(B):
            if rng.random() < 0.5 and S >= 17:
                start = int(rng.integers(8, S - 8))
                out[b, start:start + 8] = out[b, start - 8:start]
        return out.astype(np.int32)

    def next(self) -> Dict[str, np.ndarray]:
        rng = self._rng(self.step)
        self.step += 1
        cfg = self.model_cfg
        if cfg.frontend == "audio_frames":
            frames = rng.standard_normal(
                (self.batch, self.seq, cfg.d_model)).astype(np.float32)
            targets = (self._tokens(rng, (self.batch, self.seq))
                       % cfg.vocab_size)
            mask = rng.random((self.batch, self.seq)) < 0.3
            return {"frames": frames, "targets": targets, "mask": mask}
        batch = {"tokens": self._tokens(rng, (self.batch, self.seq))}
        if cfg.frontend == "vision_patches":
            batch["patches"] = rng.standard_normal(
                (self.batch, cfg.frontend_tokens, FRONTEND_DIM)
            ).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()
