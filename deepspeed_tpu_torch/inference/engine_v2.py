"""Inference engine v2: continuous batching over a paged KV cache —
counterpart of ``deepspeed_tpu/inference/engine_v2.py``.

The same scheduling as the JAX engine: ``generate`` admits prompts through
``StateManager.admit_prompt``, runs one batched prefill per admission burst
(prompts padded to a multiple of ``prefill_bucket``, rows padded to a power
of two with zero-length dummy rows that write to the trash block), then one
decode step over all ``max_tracked_sequences`` slots, inactive slots writing
to the trash block 0. PyTorch runs eagerly, so there are no compiled
programs to key; the pools are updated in place.

Ported here: ``put``, ``put_many``, ``step``, ``finish``, ``generate`` (one
host sync per decode step) and ``build_engine_v2``. Not yet: ``step_many``,
split prefill, speculative decoding, the prefix cache, ``kv_quant``,
park/resume/fork, KV export/import and the tracing planes — enabling any of
them raises (``config.check_ported``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.logging import log_dist
from .config import InferenceConfig
from .engine import InferenceEngine, ModelFamily, _round_up
from .ragged import StateManager, UnknownSequenceError  # noqa: F401 (re-export)
from .sampling import SamplingParams, sample

_GREEDY = SamplingParams(greedy=True)


class InferenceEngineV2(InferenceEngine):
    """put()/step() continuous batching; ``generate`` drains a prompt list
    through the scheduler."""

    def __init__(self, family: ModelFamily, params: Mapping[str, Any],
                 config: Optional[InferenceConfig] = None, device="cuda"):
        super().__init__(family, params, config, device)
        rc = self.config.ragged
        max_blocks_per_seq = max(
            2, (self.family.cfg.max_seq_len + rc.block_size - 1) // rc.block_size)
        self.state = StateManager(rc.max_tracked_sequences,
                                  rc.memory_config_blocks, rc.block_size,
                                  max_blocks_per_seq)
        self.cache = self.family.init_paged_cache(
            self.family.cfg, rc.memory_config_blocks, rc.block_size,
            dtype=self.dtype, device=self.device)
        B = rc.max_tracked_sequences
        self._slot_tokens = np.zeros((B,), np.int32)
        self._slot_lens = np.zeros((B,), np.int32)
        self._slot_tables = np.zeros((B, max_blocks_per_seq), np.int32)
        self._slot_active = np.zeros((B,), bool)
        # per-slot sampling params, recorded at admission
        self._slot_sp: List[SamplingParams] = [_GREEDY] * B
        # one entry per model forward: (kind, host seconds including the
        # token sync, tokens produced, monotonic end time) — what the chip
        # smoke reads TTFT and decode throughput from
        self.forward_log: List[Tuple[str, float, int, float]] = []
        log_dist(f"InferenceEngineV2: {rc.memory_config_blocks} blocks × "
                 f"{rc.block_size} tokens, {B} sequence slots on {self.device}")

    # ------------------------------------------------------------------ #
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _forward(self, tokens, tables, ctx, valid) -> torch.Tensor:
        logits, self.cache = self.family.apply_paged(
            self.family.cfg, self.model, self._tensor(tokens), self.cache,
            self._tensor(tables), self._tensor(ctx), valid=self._tensor(valid))
        return logits

    @staticmethod
    def _canon_sp(sp: SamplingParams) -> SamplingParams:
        if sp.greedy or sp.temperature == 0.0:
            return _GREEDY
        return sp

    def _sample_rows(self, last: torch.Tensor, sps: Sequence[SamplingParams],
                     seeds: Sequence[int]) -> np.ndarray:
        """last [n, V] → token ids [n]: one argmax over the batch when every
        row is greedy, else each stochastic row draws from its own
        generator (seeded per row, so a row's draw does not depend on its
        batch neighbours)."""
        toks = torch.argmax(last, dim=-1)
        for i, sp in enumerate(sps):
            if sp != _GREEDY:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(int(seeds[i]) % (1 << 63))
                toks[i] = sample(last[i], sp, gen)
        return toks.cpu().numpy().astype(np.int32)

    # ------------------------------------------------------------------ #
    def put(self, uid: int, prompt_tokens, sp: SamplingParams = _GREEDY,
            seed: int = 0) -> int:
        """Admit one sequence and run its prefill; returns the first sampled
        token."""
        return self.put_many([(uid, prompt_tokens)], sp, seed=seed)[uid]

    def put_many(self, uid_prompts, sp: SamplingParams = _GREEDY,
                 seed: int = 0) -> Dict[int, int]:
        """Admit a BATCH of sequences with one prefill → {uid: first token}.
        All-or-nothing: if capacity runs out mid-batch, already-admitted
        entries are retired before the error propagates."""
        entries = []
        try:
            for uid, p in uid_prompts:
                prompt = np.asarray(p, np.int32)
                desc, _ = self.state.admit_prompt(uid, prompt)
                entries.append((uid, prompt, desc))
        except (MemoryError, ValueError):
            for uid, _, _ in entries:
                self.state.retire(uid)
            raise
        return self._prefill_admitted(entries, [sp] * len(entries), seed)

    def _prefill_admitted(self, entries, sps, seed: int = 0) -> Dict[int, int]:
        """One batched prefill over already-admitted ``(uid, prompt, desc)``
        entries, with per-entry sampling params. Rows pad to a power of two
        with zero-length dummy rows; tokens pad to a multiple of
        ``prefill_bucket``."""
        if not entries:
            return {}
        sps = [self._canon_sp(s_) for s_ in sps]
        n = len(entries)
        n_pad = 1 << (n - 1).bit_length()
        pad_t = _round_up(max(max(len(p) for _, p, _ in entries), 1),
                          self.config.prefill_bucket)
        padded = np.zeros((n_pad, pad_t), np.int32)
        lengths = np.zeros((n_pad,), np.int32)   # dummy rows: length 0
        tables = np.zeros((n_pad, self._slot_tables.shape[1]), np.int32)
        for i, (uid, prompt, desc) in enumerate(entries):
            padded[i, :len(prompt)] = prompt
            lengths[i] = len(prompt)
            tables[i] = self.state.block_table(desc)
        valid = np.arange(pad_t)[None, :] < lengths[:, None]
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = self._forward(padded, tables, np.zeros((n_pad,), np.int32),
                                   valid)
            last_idx = self._tensor(np.maximum(lengths[:n] - 1, 0).astype(np.int64))
            last = logits[torch.arange(n, device=self.device), last_idx]
            toks = self._sample_rows(last, sps,
                                     [seed * 1_000_003 + uid for uid, _, _ in entries])
        t1 = time.perf_counter()
        self.forward_log.append(("prefill", t1 - t0, n, time.monotonic()))
        out: Dict[int, int] = {}
        for i, (uid, prompt, desc) in enumerate(entries):
            tok = int(toks[i])
            desc.seen_tokens = len(prompt)
            self.state.mark_filled(desc)
            desc.last_token = tok
            desc.generated.append(tok)
            s = desc.slot
            self._slot_tokens[s] = tok
            self._slot_lens[s] = desc.seen_tokens
            self._slot_tables[s] = tables[i]
            self._slot_active[s] = True
            self._slot_sp[s] = sps[i]
            out[uid] = tok
        return out

    def step(self, seed: int = 0) -> Dict[int, int]:
        """One decode step over every live sequence → {uid: next_token}.
        Sampling uses each sequence's admission-time params."""
        live = [d for d in self.state.seqs.values()
                if not d.finished and not d.prefilling]
        if not live:
            return {}
        for d in live:
            self.state.extend(d)
            self._slot_tables[d.slot] = self.state.block_table(d)
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = self._forward(self._slot_tokens[:, None], self._slot_tables,
                                   self._slot_lens, self._slot_active[:, None])
            nxt = self._sample_rows(logits[:, 0], self._slot_sp,
                                    [seed * 1_000_003 + s
                                     for s in range(len(self._slot_sp))])
        t1 = time.perf_counter()
        self.forward_log.append(("decode", t1 - t0, len(live), time.monotonic()))
        out: Dict[int, int] = {}
        for d in live:
            tok = int(nxt[d.slot])
            d.tokens.append(d.last_token)  # the id whose KV this step wrote
            d.seen_tokens += 1
            d.last_token = tok
            d.generated.append(tok)
            self._slot_tokens[d.slot] = tok
            self._slot_lens[d.slot] = d.seen_tokens
            self.state.mark_filled(d)
            out[d.uid] = tok
        return out

    def finish(self, uid: int) -> List[int]:
        """Retire a sequence, free its blocks, return its generated tokens.
        An unknown or finished uid raises ``UnknownSequenceError``."""
        desc = self.state.lookup(uid)
        self._clear_slot(desc.slot)
        self.state.retire(uid)
        return desc.generated

    def _clear_slot(self, s: int) -> None:
        self._slot_active[s] = False
        self._slot_lens[s] = 0
        self._slot_tables[s] = 0
        self._slot_tokens[s] = 0
        self._slot_sp[s] = _GREEDY

    # ------------------------------------------------------------------ #
    def generate(self, prompts, max_new_tokens: int = 64,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 prompt_lengths=None, steps_per_sync: int = 1,
                 sampling_params=None) -> List[List[int]]:
        """Continuous-batching driver: admit prompts as capacity allows,
        decode all live sequences each step. Returns generated ids per
        prompt. ``sampling_params``: optional per-prompt SamplingParams."""
        if steps_per_sync != 1:
            raise NotImplementedError(
                "steps_per_sync > 1 (step_many) is not yet ported to "
                "deepspeed_tpu_torch")
        sp = SamplingParams(temperature=temperature, top_k=top_k, top_p=top_p,
                            greedy=temperature == 0.0)
        if sampling_params is not None:
            if len(sampling_params) != len(prompts):
                raise ValueError(f"{len(sampling_params)} sampling_params for "
                                 f"{len(prompts)} prompts")
            sp_for = list(sampling_params)
        else:
            sp_for = [sp] * len(prompts)
        prompts = [np.asarray(p, np.int32) for p in prompts]
        if prompt_lengths is not None:
            prompts = [p[:n] for p, n in zip(prompts, prompt_lengths)]
        pending = list(enumerate(prompts))
        results: Dict[int, List[int]] = {}
        # reject prompts that can NEVER be admitted instead of spinning
        bs = self.state.block_size
        capacity = self.state.allocator.num_blocks - 1
        for _, p in pending:
            need = (len(p) + bs - 1) // bs + 1
            if need > capacity:
                raise MemoryError(
                    f"prompt of {len(p)} tokens needs {need} KV blocks but the "
                    f"pool only holds {capacity}; raise ragged.memory_config_blocks")
        step_i = 0
        while pending or self.state.seqs:
            batch_adm = []
            while pending and self.state.can_admit(len(pending[0][1])):
                uid, prompt = pending.pop(0)
                desc, _ = self.state.admit_prompt(uid, prompt)
                batch_adm.append((uid, prompt, desc))
            if batch_adm:  # one prefill for the whole burst
                self._prefill_admitted(
                    batch_adm, [sp_for[uid] for uid, _, _ in batch_adm],
                    seed=seed)
            self.step(seed=seed + step_i)
            step_i += 1
            for uid in list(self.state.seqs):
                d = self.state.seqs[uid]
                hit_eos = eos_token_id is not None and d.last_token == eos_token_id
                if len(d.generated) >= max_new_tokens or hit_eos or \
                        d.seen_tokens >= self.family.cfg.max_seq_len:
                    d.generated = d.generated[:max_new_tokens]
                    results[uid] = self.finish(uid)
        return [results[i] for i in range(len(prompts))]


def build_engine_v2(model, model_cfg, params: Mapping[str, Any], config=None,
                    device="cuda", **kwargs) -> InferenceEngineV2:
    """Counterpart of the JAX ``build_engine_v2``: ``model`` is the family's
    module (``deepspeed_tpu_torch.models.llama``), ``params`` its
    ``state_dict`` (``llama.init`` or ``models.convert.from_jax_params``).
    Runs on the GPU unless ``device="cpu"`` is asked for."""
    if isinstance(config, dict) or config is None:
        config = InferenceConfig.from_dict({**(config or {}), **kwargs})
    family = ModelFamily.from_module(model, model_cfg)
    return InferenceEngineV2(family, params, config, device=device)
