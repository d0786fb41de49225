"""Inference engine v2: continuous batching over a paged KV cache —
counterpart of ``deepspeed_tpu/inference/engine_v2.py``.

The same scheduling as the JAX engine: ``generate`` admits prompts through
``StateManager.admit_prompt``, runs one batched prefill per admission burst
(prompts padded to a multiple of ``prefill_bucket``, rows padded to a power
of two with zero-length dummy rows that write to the trash block), then one
decode step over all ``max_tracked_sequences`` slots, inactive slots writing
to the trash block 0. PyTorch runs eagerly, so there are no compiled
programs to key; the pools are updated in place.

Speculative decoding (``inference.speculative``, default OFF): the
prompt-lookup drafter (:func:`prompt_lookup_draft`) proposes up to k tokens
per live sequence from its own history; ONE batched forward over the paged
cache scores ``[last_token, draft_1..k]`` for every slot; acceptance runs on
the device (greedy rows by argmax, stochastic rows by exact rejection
sampling) with one host sync per step; rejected positions are rolled back
with ``StateManager.truncate``. With ``fused_verify`` that forward's
attention is the paged spec-verify kernel instead of the gathered-view
prefill read. Quantized KV (``inference.kv_quant``, default OFF): int8 code
pools with fp32 scales (``models/_paged.py``).

Ported here: ``put``, ``put_many``, ``step``, ``finish``, ``generate`` (one
host sync per step), speculative decoding with fused verification,
``kv_quant`` and ``build_engine_v2``. Not yet: ``step_many``, split
prefill, the prefix cache, park/resume/fork, KV export/import and the
tracing planes — enabling any of them raises (``config.check_ported``).
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models._paged import fused_verify_scope
from ..utils.logging import log_dist
from .config import InferenceConfig
from .engine import InferenceEngine, ModelFamily, _round_up
from .ragged import StateManager, UnknownSequenceError  # noqa: F401 (re-export)
from .sampling import SamplingParams, filter_logits_batch, sample, sp_arrays

_GREEDY = SamplingParams(greedy=True)


def prompt_lookup_draft(history, max_tokens: int, ngram_max: int = 3,
                        min_match: int = 1) -> List[int]:
    """Prompt-lookup (n-gram) drafting: match the TRAILING n-gram of
    ``history`` (n from ``ngram_max`` down to ``min_match``) against an
    earlier occurrence and propose up to ``max_tokens`` of the tokens that
    followed it — the most recent occurrence wins. Returns ``[]`` when
    nothing matches (the caller then runs a plain decode step)."""
    n_hist = len(history)
    if max_tokens <= 0 or n_hist < max(1, min_match) + 1:
        return []
    arr = np.asarray(history, np.int32)
    for n in range(min(ngram_max, n_hist - 1), max(1, min_match) - 1, -1):
        pat = arr[n_hist - n:]
        # windows over arr[:-1]: every match start i has i + n <= n_hist - 1,
        # so a continuation token exists and the trailing n-gram never
        # matches itself
        win = np.lib.stride_tricks.sliding_window_view(arr[:n_hist - 1], n)
        hits = np.flatnonzero((win == pat).all(axis=1))
        if hits.size:
            start = int(hits[-1]) + n
            return arr[start:start + max_tokens].tolist()
    return []


def _row_generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


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
        # quantized KV cache: int8 code pools + fp32 scale pools, validated
        # as the JAX engine does (engine_v2.py:106-129)
        kq = self.config.kv_quant
        self._kvq_on = bool(kq.enabled)
        self._kvq_group = 0
        pool_kw = {}
        if self._kvq_on:
            if kq.dtype != "int8":
                raise ValueError(f"inference.kv_quant.dtype {kq.dtype!r} is not "
                                 "wired — only 'int8' is supported")
            hd = self.family.cfg.head_size
            eff = min(int(kq.group_size), hd)
            if eff < 1 or hd % eff:
                raise ValueError(f"inference.kv_quant.group_size {kq.group_size} "
                                 f"does not divide head_size {hd}")
            self._kvq_group = pool_kw["kv_quant_group"] = eff
        try:
            self.cache = self.family.init_paged_cache(
                self.family.cfg, rc.memory_config_blocks, rc.block_size,
                dtype=self.dtype, device=self.device, **pool_kw)
        except TypeError:
            if not pool_kw:
                raise
            raise ValueError("this model's init_paged_cache does not accept "
                             "kv_quant_group — the family has no quantized KV "
                             "path; disable inference.kv_quant") from None
        # speculative decoding (default OFF: step() runs the plain decode)
        sc = self.config.speculative
        self._spec_on = bool(sc.enabled)
        self._spec_k = max(1, int(sc.max_draft_tokens))
        self._spec_ngram_max = max(1, int(sc.ngram_max))
        self._spec_min_match = max(1, int(sc.min_match))
        self._spec_fused = bool(self._spec_on and sc.fused_verify)
        # cumulative counters, the JAX engine's: model steps in spec mode
        # split into verify steps (>= 1 draft scored) and plain decode
        # fallbacks, plus drafted/accepted/emitted/rolled-back tokens and
        # verify-batch occupancy (valid positions / batch capacity)
        self.spec_stats: Dict[str, int] = {
            "verify_steps": 0, "decode_steps": 0, "step_seqs": 0,
            "drafted_tokens": 0, "accepted_tokens": 0, "emitted_tokens": 0,
            "rolled_back_tokens": 0, "verify_positions": 0,
            "verify_capacity": 0, "fused_verify_steps": 0}
        B = rc.max_tracked_sequences
        self._slot_tokens = np.zeros((B,), np.int32)
        self._slot_lens = np.zeros((B,), np.int32)
        self._slot_tables = np.zeros((B, max_blocks_per_seq), np.int32)
        self._slot_active = np.zeros((B,), bool)
        # per-slot sampling params, recorded at admission
        self._slot_sp: List[SamplingParams] = [_GREEDY] * B
        # one entry per model forward: (kind — "prefill", "decode" or
        # "verify" —, host seconds including the token sync, tokens
        # produced, monotonic end time) — what the chip smoke reads TTFT,
        # step times and throughput from
        self.forward_log: List[Tuple[str, float, int, float]] = []
        spec_lbl = "off"
        if self._spec_on:
            spec_lbl = "on(k=%d%s)" % (self._spec_k,
                                       ",fused" if self._spec_fused else "")
        kvq_lbl = "int8(g=%d)" % self._kvq_group if self._kvq_on else "off"
        log_dist(f"InferenceEngineV2: {rc.memory_config_blocks} blocks × "
                 f"{rc.block_size} tokens, {B} sequence slots on {self.device}, "
                 f"kv_quant={kvq_lbl}, speculative={spec_lbl}")

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
                toks[i] = sample(last[i], sp, _row_generator(self.device, seeds[i]))
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

    def step(self, seed: int = 0) -> Dict[int, Any]:
        """One decode step over every live sequence → {uid: next_token}.
        Sampling uses each sequence's admission-time params.

        With ``inference.speculative.enabled`` the step drafts and verifies
        instead (:meth:`_spec_step`) and may emit several tokens per
        sequence, so every value is a list ({uid: [tokens]}), draft-less
        fallback steps included."""
        live = [d for d in self.state.seqs.values()
                if not d.finished and not d.prefilling]
        if not live:
            return {}
        if self._spec_on:
            spec_out = self._spec_step(live, seed)
            if spec_out is not None:
                return spec_out
            # no sequence drafted: the plain decode below, as in a non-spec
            # step
            self.spec_stats["decode_steps"] += 1
            self.spec_stats["step_seqs"] += len(live)
            self.spec_stats["emitted_tokens"] += len(live)
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
        out: Dict[int, Any] = {}
        for d in live:
            tok = int(nxt[d.slot])
            d.tokens.append(d.last_token)  # the id whose KV this step wrote
            d.seen_tokens += 1
            d.last_token = tok
            d.generated.append(tok)
            self._slot_tokens[d.slot] = tok
            self._slot_lens[d.slot] = d.seen_tokens
            self.state.mark_filled(d)
            out[d.uid] = [tok] if self._spec_on else tok
        return out

    # ------------------------------------------------------------------ #
    # speculative decoding: prompt-lookup drafts, one batched verify
    # forward, acceptance on the device, KV rollback
    # ------------------------------------------------------------------ #
    def _copy_blocks(self, pairs) -> None:
        """Apply the (src, dst) whole-block copies ``StateManager``
        scheduled (copy-on-write, truncate into a shared block) to every
        pool — codes and scales alike — before the step that writes dst."""
        for src, dst in pairs:
            for pool in self.cache.values():
                pool[:, dst] = pool[:, src]

    def _draft_tokens(self, desc) -> List[int]:
        """Prompt-lookup draft for one live sequence, clamped so the verify
        write window ``[seen, seen + len + 1)`` stays inside max_seq_len and
        the fixed-width block table."""
        room = min(self.family.cfg.max_seq_len,
                   self.state.max_blocks_per_seq * self.state.block_size) \
            - desc.seen_tokens - 1
        k = min(self._spec_k, room)
        if k <= 0:
            return []
        return prompt_lookup_draft(desc.tokens + [desc.last_token], k,
                                   self._spec_ngram_max, self._spec_min_match)

    def _verify(self, tok_w: np.ndarray, nvalid: np.ndarray, drafts: np.ndarray,
                uids: np.ndarray, seed: int) -> Tuple[np.ndarray, np.ndarray]:
        """ONE forward over every slot's ``[last_token, draft_1..k]`` at
        context offset ``lens`` (positions past ``nvalid`` masked to the
        trash block), then acceptance on the device: greedy rows accept
        draft j while it equals the argmax of the logits before it;
        stochastic rows accept with probability ``p(draft_j)`` under their
        own filtered distribution — exact rejection sampling for the
        deterministic drafter, the correction drawn from p without the
        rejected token. When every draft is accepted the bonus position
        gives one more token. Returns (accepted length [B], next token [B])
        after one host sync."""
        B, kp1 = tok_w.shape
        k = kp1 - 1
        dev = self.device
        valid = (np.arange(kp1)[None, :] < nvalid[:, None]) \
            & self._slot_active[:, None]
        with fused_verify_scope() if self._spec_fused else nullcontext():
            logits = self._forward(tok_w, self._slot_tables, self._slot_lens, valid)
        amax = logits.argmax(-1)                                   # [B, kp1]
        dr = self._tensor(drafts.astype(np.int64))                 # [B, k]
        draft_len = self._tensor(nvalid.astype(np.int64)) - 1
        stochastic = [i for i, sp in enumerate(self._slot_sp) if sp != _GREEDY]
        ok = dr == amax[:, :k]
        if stochastic:
            temp, topk, topp, greedy = map(self._tensor, sp_arrays(self._slot_sp))
            is_greedy = greedy | (temp <= 0.0)
            V = logits.shape[-1]
            filt = filter_logits_batch(
                logits.reshape(B * kp1, V), temp.repeat_interleave(kp1),
                topk.repeat_interleave(kp1), topp.repeat_interleave(kp1)
            ).reshape(B, kp1, V)
            probs = torch.softmax(filt, dim=-1)
            # per-row draws from a generator seeded by (seed, uid), so a
            # row's draws do not depend on its batch neighbours
            accept_u = torch.zeros(B, k, device=dev)
            gumbel = torch.zeros(B, V, device=dev)
            for i in stochastic:
                gen = _row_generator(dev, seed * 1_000_003 + int(uids[i]))
                accept_u[i] = torch.rand(k, generator=gen, device=dev)
                u = torch.rand(V, generator=gen, device=dev).clamp_min(1e-20)
                gumbel[i] = -torch.log(-torch.log(u))
            p_draft = probs[:, :k].gather(-1, dr[..., None])[..., 0]
            ok = torch.where(is_greedy[:, None], ok, accept_u < p_draft)
        ok = ok & (torch.arange(k, device=dev)[None, :] < draft_len[:, None])
        # longest agreeing prefix: cumprod zeroes everything after the
        # first rejection
        m = torch.cumprod(ok.long(), dim=1).sum(dim=1)             # [B]
        nxt = amax.gather(1, m[:, None])[:, 0]
        if stochastic:
            lm = filt.gather(1, m[:, None, None].expand(B, 1, filt.shape[-1]))[:, 0]
            rejected = m < draft_len
            d_m = dr.gather(1, m.clamp(max=k - 1)[:, None])[:, 0]
            vocab = torch.arange(lm.shape[-1], device=dev)[None, :]
            residual = lm.masked_fill(rejected[:, None] & (vocab == d_m[:, None]),
                                      float("-inf"))
            # Gumbel-max: a categorical draw from the residual without a sync
            sampled = (residual + gumbel).argmax(-1)
            nxt = torch.where(is_greedy, nxt, sampled)
        res = torch.stack([m, nxt]).cpu().numpy()                  # the one sync
        return res[0], res[1]

    def _spec_step(self, live, seed: int = 0) -> Optional[Dict[int, List[int]]]:
        """One speculative decode step over ``live``: draft, verify every
        draft position in one batched forward, accept the longest agreeing
        prefix per sequence, roll back rejected KV. Returns {uid: [emitted
        tokens]} — at least one token per sequence, up to
        ``max_draft_tokens + 1`` — or None when no sequence drafted (the
        caller then runs a plain decode step)."""
        drafts = {d.uid: self._draft_tokens(d) for d in live}
        bs = self.state.block_size
        # capacity guard: verification may need blocks for up to k + 1 new
        # positions per sequence; if the pool cannot cover the batch, drop
        # the drafts — a plain decode step needs the fewest blocks
        need = 0
        for d in live:
            want = d.seen_tokens + len(drafts[d.uid]) + 1
            need += max(0, (want + bs - 1) // bs - len(d.blocks))
        if need > self.state.allocator.free_blocks + self.state.retained_blocks:
            drafts = {u: [] for u in drafts}
        if not any(drafts.values()):
            return None
        kmax = self._spec_k
        st = self.spec_stats
        st["verify_steps"] += 1
        if self._spec_fused:
            st["fused_verify_steps"] += 1
        st["step_seqs"] += len(live)
        cow = []
        for d in live:
            dl = len(drafts[d.uid])
            cow += self.state.ensure_writable(d, d.seen_tokens + dl + 1)
            self.state.extend(d, n=dl + 1)
            self._slot_tables[d.slot] = self.state.block_table(d)
        self._copy_blocks(cow)
        B = self._slot_tokens.shape[0]
        tok_w = np.zeros((B, kmax + 1), np.int32)
        tok_w[:, 0] = self._slot_tokens
        dr_arr = np.zeros((B, kmax), np.int32)
        nvalid = np.ones((B,), np.int32)
        uids_arr = np.zeros((B,), np.int64)
        for d in live:
            dr = drafts[d.uid]
            dr_arr[d.slot, :len(dr)] = dr
            tok_w[d.slot, 1:len(dr) + 1] = dr
            nvalid[d.slot] = 1 + len(dr)
            uids_arr[d.slot] = d.uid
        t0 = time.perf_counter()
        with torch.no_grad():
            m, nxt = self._verify(tok_w, nvalid, dr_arr, uids_arr, seed)
        t1 = time.perf_counter()
        out: Dict[int, List[int]] = {}
        for d in live:
            dr = drafts[d.uid]
            dl = len(dr)
            mi = min(int(m[d.slot]), dl)
            tok = int(nxt[d.slot])
            # KV positions seen..seen+dl now hold [last_token] + drafts;
            # record them, then un-fill the rejected suffix
            d.tokens.extend([d.last_token] + dr)
            d.seen_tokens += dl + 1
            if mi < dl:
                self._copy_blocks(self.state.truncate(d, d.seen_tokens - (dl - mi)))
                self._slot_tables[d.slot] = self.state.block_table(d)
            emitted = dr[:mi] + [tok]
            d.last_token = tok
            d.generated.extend(emitted)
            self._slot_tokens[d.slot] = tok
            self._slot_lens[d.slot] = d.seen_tokens
            self.state.mark_filled(d)
            out[d.uid] = emitted
            st["drafted_tokens"] += dl
            st["accepted_tokens"] += mi
            st["emitted_tokens"] += mi + 1
            st["rolled_back_tokens"] += dl - mi
            st["verify_positions"] += dl + 1
            st["verify_capacity"] += kmax + 1
        self.forward_log.append(("verify", t1 - t0,
                                 sum(len(v) for v in out.values()), time.monotonic()))
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
        prompt. ``sampling_params``: optional per-prompt SamplingParams. In
        spec mode each step may emit several tokens (``steps_per_sync`` is
        then subsumed, as in the JAX engine)."""
        if steps_per_sync != 1 and not self._spec_on:
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
                if eos_token_id is not None and eos_token_id in d.generated:
                    # a verify step may emit tokens past the first EOS
                    d.generated = d.generated[:d.generated.index(eos_token_id) + 1]
                    d.last_token = d.generated[-1]
                hit_eos = eos_token_id is not None and d.last_token == eos_token_id
                if len(d.generated) >= max_new_tokens or hit_eos or \
                        d.seen_tokens >= self.family.cfg.max_seq_len:
                    d.generated = d.generated[:max_new_tokens]
                    results[uid] = self.finish(uid)
        return [results[i] for i in range(len(prompts))]


def build_engine_v2(model, model_cfg, params: Mapping[str, Any], config=None,
                    device="cuda", **kwargs) -> InferenceEngineV2:
    """Counterpart of the JAX ``build_engine_v2``: ``model`` is the family's
    module (``deepspeed_tpu_torch.models.llama`` or ``.gpt``), ``params`` its
    ``state_dict`` (the family's ``init`` or ``models.convert.from_jax_params``).
    Runs on the GPU unless ``device="cpu"`` is asked for."""
    if isinstance(config, dict) or config is None:
        config = InferenceConfig.from_dict({**(config or {}), **kwargs})
    family = ModelFamily.from_module(model, model_cfg)
    return InferenceEngineV2(family, params, config, device=device)
