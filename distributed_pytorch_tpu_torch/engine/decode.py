"""Continuous-batching decode engine over a PAGED KV cache with radix
prefix reuse.

Counterpart of the reference package's `engine/decode.py` (`DecodeEngine`,
`Retired`, `Admission`, `StepResult`, `RETIRE_REASONS`) for PyTorch. The
host side — slots, the block allocator and radix index
(ops/block_pool.py), preemption and requeue, retirement accounting — is
the reference's logic as it is; the device side is eager PyTorch in place
of jitted programs:

* **Paged pool + block tables**: ONE (n_blocks, block_size, nkv, hs) pool
  pair per layer lives for the engine's lifetime; each live sequence owns
  an ordered list of blocks recorded in its row of the (n_slots,
  max_blocks) table. Writes scatter through the table; attention reads
  blocks straight from the pool through the CUDA kernels
  (ops/flash_decode.py). Retired slots' table rows are zeroed so the
  step's dead-slot write lands in the reserved null block.
* **Radix prefix reuse**: full prompt blocks are content-addressed by chain
  key; an admission SHARES the longest cached block-chain prefix and
  prefills only the suffix, right-padded to its pow2 bucket — one
  `paged_prefill_attn` launch per layer at the reused offset.
* **Block-level preemption**: when a live sequence needs a block and every
  block is referenced, the youngest-admitted sequence retires with reason
  'preempted' and its tokens so far; callers (`run`, serve/scheduler.py)
  requeue it, and its published blocks make the re-prefill a prefix hit.
* **One step advances every live slot**: a (n_slots, 1) forward with
  per-slot positions — one `paged_decode_attn` launch per layer — then
  sampling on the device, one host sync for the sampled tokens.

Not ported yet (later slices): chunked prefill, speculative decoding, int8
KV and weights, the host-RAM KV tier, the AOT program store, meshes.
`trace_guards` is an empty dict and `aot_store` None — eager PyTorch
compiles no programs — so the scheduler's trace and store gauges read 0.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from distributed_pytorch_tpu_torch.models.generate import sample_token
from distributed_pytorch_tpu_torch.models.gpt import init_paged_cache
from distributed_pytorch_tpu_torch.obs.flight import FlightRecorder
from distributed_pytorch_tpu_torch.ops.block_pool import (BlockPool,
                                                          NoFreeBlocks,
                                                          chain_keys)


#: Why a sequence left its slot — the serving layer routes on these.
#: 'preempted' carries partial output that callers REQUEUE, never drop.
RETIRE_REASONS = ("eos", "budget", "cache_full", "cancelled", "preempted")


def prefill_bucket_for(prompt_len: int, min_bucket: int, block_size: int,
                       max_len: int) -> int:
    """The pow2 bucket a (suffix of this length's) prefill runs in —
    admissions sharing a bucket share one prefill shape. The floor is
    max(min_bucket, block_size) so buckets stay whole blocks."""
    b = max(min_bucket, block_size)
    while b < prompt_len:
        b *= 2
    return min(b, max_len)


@dataclasses.dataclass
class Retired:
    """A finished sequence: its tokens (prompt + generated) and why it
    stopped — 'eos' | 'budget' | 'cache_full' | 'cancelled' |
    'preempted' (the pool needed its blocks; resubmit `tokens` with the
    remaining budget to resume from the retained prefix blocks)."""

    tokens: list
    reason: str
    prompt_len: int


@dataclasses.dataclass
class Admission:
    """What `admit()` hands back: the sequence id, the first sampled token
    (prefill samples it — a streaming caller's TTFT token), prefix-cache
    accounting (`prefix_len` reused tokens, `prefilled` suffix tokens
    computed), and, for a request that finished AT prefill (1-token
    budget, instant EOS), its `Retired` record."""

    seq_id: int
    first_token: Optional[int]
    retired: Optional[Retired] = None
    prefix_len: int = 0
    prefilled: int = 0


@dataclasses.dataclass
class StepResult:
    """One step's host-visible output: `emitted` maps every sequence that
    advanced to the LIST of tokens it emitted (one per plain step);
    `retired` holds the sequences that finished, including any preempted
    BEFORE the step ran (those emit no token). `prefill_tokens`,
    `drafted` and `accepted` keep the reference's surface for the
    scheduler and stay 0 until chunked prefill and speculative decoding
    are ported."""

    emitted: dict
    retired: dict
    prefill_tokens: int = 0
    drafted: int = 0
    accepted: int = 0


@dataclasses.dataclass
class _Slot:
    """Host-side bookkeeping for one occupied table row."""

    seq_id: int
    tokens: list          # prompt + generated so far
    prompt_len: int
    n_new: int            # generated tokens recorded so far
    max_new: int
    pos: int              # device pos mirror: next cache write position
    blocks: list          # owned physical block ids, logical order
    order: int            # admission counter (preemption picks the max)


class DecodeEngine:
    """Continuous batching over the paged KV cache: admit prompts (sharing
    any cached prefix), step all live slots at once, retire finished
    sequences, preempt-and-requeue when the pool runs dry.

    >>> eng = DecodeEngine(model, n_slots=8, temperature=0.0)
    >>> outs = eng.run(prompts, max_new_tokens=64)   # list of token lists

    The engine runs on `model`'s device, with a KV cache in the model's
    dtype. Paging knobs: `block_size` (KV rows per block, pow2; default
    16 capped at `min_bucket` so the pow2 buckets stay block-aligned),
    `n_blocks` (pool size; default the slot cache's n_slots x max_len
    footprint plus the null block), `prefix_cache=False` disables
    content-addressed reuse. `seed` seeds the sampling generator (on the
    model's device).

    The stable accounting surface a scheduler reads: `n_free`/`occupancy`
    /`retire_counts` plus `block_utilization`/`block_fragmentation`/
    `prefix_hit_rate`/`prefilled_tokens` (never the private `_slots`).
    """

    def __init__(self, model, *, n_slots: int = 8,
                 max_len: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 eos_id: Optional[int] = None, seed: int = 0,
                 min_bucket: int = 16, block_size: Optional[int] = None,
                 n_blocks: Optional[int] = None, prefix_cache: bool = True):
        cfg = model.config
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.n_slots = n_slots
        self.max_len = max_len or cfg.block_size
        assert self.max_len <= cfg.block_size
        self.cache_dtype = model.dtype
        self.temperature = temperature
        self.top_k = top_k
        self.eos_id = eos_id
        self.min_bucket = min_bucket
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

        # paged-cache geometry: pow2 blocks no larger than the smallest
        # prefill bucket, so every bucket is a whole number of blocks
        bs = block_size or min(16, min_bucket)
        assert bs > 0 and bs & (bs - 1) == 0, \
            f"block_size must be a power of two, got {bs}"
        assert self.max_len % bs == 0, \
            f"max_len {self.max_len} not a multiple of block_size {bs}"
        self.block_size = bs
        self.max_blocks = self.max_len // bs
        if n_blocks is None:
            n_blocks = n_slots * self.max_blocks + 1
            n_blocks += (-n_blocks) % 8
        assert n_blocks > self.max_blocks, (
            f"pool of {n_blocks} blocks cannot hold one max_len sequence "
            f"({self.max_blocks} blocks) plus the null block")
        self.n_blocks = n_blocks
        self.block_pool = BlockPool(n_blocks, bs)
        self.prefix_cache = prefix_cache

        self.caches = init_paged_cache(cfg, n_blocks, bs,
                                       dtype=self.cache_dtype,
                                       device=self.device)
        self.tok = torch.zeros(n_slots, dtype=torch.long, device=self.device)
        self.pos = torch.zeros(n_slots, dtype=torch.long, device=self.device)
        self.live = torch.zeros(n_slots, dtype=torch.bool, device=self.device)
        # host-mirrored block tables: rows of physical block ids per slot;
        # zeroed rows route dead-slot writes to the null block
        self._tables_h = np.zeros((n_slots, self.max_blocks), np.int32)
        self._tables_dirty = True
        self.block_tables = None
        self._sync_tables()

        self._slots: dict[int, _Slot] = {}     # slot index -> bookkeeping
        self._next_id = 0
        self._t = 0                            # global step counter
        # eager PyTorch compiles no programs: no retrace guards, no store
        self.trace_guards: dict = {}
        self.aot_store = None
        # lifetime counters — the stable occupancy/accounting surface a
        # scheduler reads instead of poking _slots
        self.n_admitted = 0
        self.retire_counts = dict.fromkeys(RETIRE_REASONS, 0)
        self.prompt_tokens = 0        # prompt tokens across admissions
        self.prefix_hit_tokens = 0    # of those, served from cached blocks
        self.prefilled_tokens = 0     # suffix tokens actually prefilled
        # step-level flight recorder (obs/flight.py)
        self.flight = FlightRecorder(capacity=4096)

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------

    def _sample(self, logits):
        return sample_token(logits, self._gen, temperature=self.temperature,
                            top_k=self.top_k)

    def _sync_tables(self) -> None:
        """Push the host block tables to the device when they changed —
        BEFORE any step/admit, so a retired slot's zeroed row is live by
        the time the next dead-slot write could land."""
        if not self._tables_dirty:
            return
        self.block_tables = torch.from_numpy(self._tables_h.copy()).to(
            self.device)
        self._tables_dirty = False

    @torch.no_grad()
    def _prefill(self, slot: int, suffix: list, bucket: int,
                 prefix_len: int) -> torch.Tensor:
        """Bucketed suffix prefill straight into the slot's pool blocks,
        starting at the reused prefix; activates the slot on the device
        and returns its first sampled token (1,)."""
        padded = torch.tensor([suffix + [0] * (bucket - len(suffix))],
                              dtype=torch.long, device=self.device)
        logits = self.model(padded, self.caches, prefix_len,
                            logits_idx=[len(suffix) - 1],
                            block_tables=self.block_tables[slot:slot + 1])
        first = self._sample(logits[:, -1, :])
        self.tok[slot] = first[0]
        self.pos[slot] = prefix_len + len(suffix)
        self.live[slot] = True
        return first

    @torch.no_grad()
    def _decode_step(self) -> None:
        """Advance every live slot by one token. Dead slots freeze their
        token and position; their zeroed table rows send the write to the
        null block."""
        logits = self.model(self.tok[:, None], self.caches, self.pos,
                            block_tables=self.block_tables)
        nxt = self._sample(logits[:, -1, :])
        self.tok = torch.where(self.live, nxt, self.tok)
        self.pos = self.pos + self.live.long()

    # ------------------------------------------------------------------
    # host API
    # ------------------------------------------------------------------

    @property
    def free_slots(self) -> list[int]:
        return [s for s in range(self.n_slots) if s not in self._slots]

    def _rebuild_live(self) -> None:
        mask = np.zeros((self.n_slots,), bool)
        mask[list(self._slots)] = True
        self.live = torch.from_numpy(mask).to(self.device)

    @property
    def n_live(self) -> int:
        return len(self._slots)

    @property
    def n_free(self) -> int:
        return self.n_slots - len(self._slots)

    @property
    def occupancy(self) -> float:
        """Live fraction of the slot table, 0.0..1.0."""
        return len(self._slots) / self.n_slots

    @property
    def block_utilization(self) -> float:
        """Referenced fraction of the block pool (cached-but-unreferenced
        prefix blocks are reclaimable and don't count)."""
        return self.block_pool.utilization

    @property
    def block_fragmentation(self) -> float:
        """Internal fragmentation of live blocks: the fraction of rows in
        referenced blocks not (yet) holding a valid token."""
        live_blocks = sum(len(s.blocks) for s in self._slots.values())
        if not live_blocks:
            return 0.0
        used = sum(min(s.pos, len(s.blocks) * self.block_size)
                   for s in self._slots.values())
        return 1.0 - used / (live_blocks * self.block_size)

    @property
    def prefix_hit_rate(self) -> float:
        """Lifetime fraction of prompt tokens served from cached blocks."""
        return (self.prefix_hit_tokens / self.prompt_tokens
                if self.prompt_tokens else 0.0)

    @property
    def n_steps(self) -> int:
        """Decode steps executed so far."""
        return self._t

    def prefill_bucket(self, prompt_len: int) -> int:
        """See `prefill_bucket_for`."""
        return prefill_bucket_for(prompt_len, self.min_bucket,
                                  self.block_size, self.max_len)

    def _register_blocks(self, tokens: list, n_full: int,
                         blocks: list) -> None:
        """Publish the first `n_full` full blocks of `tokens` under their
        chain keys (first-writer-wins)."""
        if not self.prefix_cache or n_full <= 0:
            return
        for key, blk in zip(chain_keys(tokens, self.block_size, n_full),
                            blocks):
            self.block_pool.register(blk, key)

    def _retire_reason(self, slot: int, last_tok: int) -> Optional[str]:
        seq = self._slots[slot]
        if self.eos_id is not None and last_tok == self.eos_id:
            return "eos"
        if seq.n_new >= seq.max_new:
            return "budget"
        if seq.pos >= self.max_len:  # table capacity: no next row exists
            return "cache_full"
        return None

    def _retire(self, slot: int, reason: str) -> Retired:
        seq = self._slots.pop(slot)
        self.retire_counts[reason] += 1
        # publish the sequence's full blocks into the prefix cache before
        # releasing: refcount-0 registered blocks land on the LRU, so a
        # follow-up (or a preemption resume) re-admits with a prefix hit
        full = min(seq.pos, len(seq.blocks) * self.block_size) \
            // self.block_size
        self._register_blocks(seq.tokens, full, seq.blocks)
        self.block_pool.release_all(seq.blocks)
        self._tables_h[slot, :] = 0
        self._tables_dirty = True
        return Retired(tokens=seq.tokens, reason=reason,
                       prompt_len=seq.prompt_len)

    def cancel(self, seq_id: int) -> Optional[Retired]:
        """Free a live sequence's slot and blocks immediately (client
        disconnect). Returns its partial `Retired(reason='cancelled')`, or
        None when the id is not live."""
        for slot, seq in self._slots.items():
            if seq.seq_id == seq_id:
                ret = self._retire(slot, "cancelled")
                self.live[slot] = False
                return ret
        return None

    def _match_prefix(self, toks: list) -> tuple[int, list]:
        """Longest cached block-chain prefix of `toks`, capped so at least
        one suffix token remains to prefill. Returns (prefix_len, matched
        block ids) WITH one reference taken per matched block — callers
        own the refs (`release_all(matched)` on admission rollback)."""
        if not self.prefix_cache:
            return 0, []
        matched: list[int] = []
        limit = (len(toks) - 1) // self.block_size
        for key in chain_keys(toks, self.block_size, limit):
            blk = self.block_pool.lookup(key)
            if blk is None:
                break
            self.block_pool.ref(blk)
            matched.append(blk)
        return len(matched) * self.block_size, matched

    def admit(self, prompt, max_new_tokens: int,
              seq_id: Optional[int] = None) -> Admission:
        """Prefill `prompt` (1D int sequence) into a free slot, reusing
        any cached block-aligned prefix. Returns an `Admission`. Raises
        AssertionError when no slot is free (check `free_slots`) and
        `NoFreeBlocks` when the pool cannot cover the suffix even after
        evicting every unreferenced cached block — the caller keeps the
        request queued and admits again after a retirement."""
        free = self.free_slots
        assert free, "no free slot — step()/retire before admitting"
        assert max_new_tokens >= 1
        slot = free[0]
        toks = [int(t) for t in prompt]
        # keep at least one free cache row to decode into
        toks = toks[-(self.max_len - 1):]
        L = len(toks)
        bs = self.block_size
        prefix_len, matched = self._match_prefix(toks)
        suffix = toks[prefix_len:]
        bucket = min(self.prefill_bucket(len(suffix)),
                     self.max_len - prefix_len)
        new_ids = self.block_pool.alloc_many(bucket // bs)
        if new_ids is None:
            self.block_pool.release_all(matched)
            raise NoFreeBlocks(
                f"pool exhausted: {self.block_pool.n_referenced} of "
                f"{self.block_pool.capacity} blocks referenced by "
                f"{self.n_live} live sequences; admit after a retirement")
        blocks = matched + new_ids
        self._tables_h[slot, :] = 0
        self._tables_h[slot, :len(blocks)] = blocks
        self._tables_dirty = True
        self._sync_tables()

        if seq_id is None:
            seq_id = self._next_id
        self._next_id = max(self._next_id, seq_id) + 1
        first = self._prefill(slot, suffix, bucket, prefix_len)
        # THE admit sync boundary: the first sampled token must reach the
        # host to stream it to the caller
        first_tok = int(first[0])
        self._slots[slot] = _Slot(seq_id=seq_id, tokens=toks + [first_tok],
                                  prompt_len=L, n_new=1,
                                  max_new=max_new_tokens, pos=L,
                                  blocks=blocks, order=self.n_admitted)
        self.n_admitted += 1
        self.prompt_tokens += L
        self.prefix_hit_tokens += prefix_len
        self.prefilled_tokens += len(suffix)
        # publish the prompt's full blocks now — immutable as of this
        # prefill — so concurrent same-prefix requests hit immediately
        self._register_blocks(toks, L // bs, blocks)
        # a 1-token request (or instant EOS) finishes at admission
        retired = None
        reason = self._retire_reason(slot, first_tok)
        if reason is not None:
            retired = self._retire(slot, reason)
            self.live[slot] = False
        return Admission(seq_id=seq_id, first_token=first_tok,
                         retired=retired, prefix_len=prefix_len,
                         prefilled=len(suffix))

    def _pick_victim(self) -> int:
        """Slot of the youngest-admitted live sequence — the last one in
        has the least sunk decode work and the best chance of a prefix
        hit on resume."""
        return max(self._slots, key=lambda s: self._slots[s].order)

    def _ensure_blocks(self) -> dict:
        """Grow every live sequence's block list to cover its next write;
        when the pool is dry (all blocks referenced), preempt
        youngest-first until the allocation succeeds. Returns
        {seq_id: Retired(reason='preempted')} for the victims."""
        preempted: dict[int, Retired] = {}
        for slot in sorted(self._slots):
            seq = self._slots.get(slot)
            while seq is not None and \
                    seq.pos >= len(seq.blocks) * self.block_size:
                blk = self.block_pool.alloc()
                if blk is not None:
                    self._tables_h[slot, len(seq.blocks)] = blk
                    seq.blocks.append(blk)
                    self._tables_dirty = True
                    continue
                victim = self._pick_victim()
                vseq = self._slots[victim]
                preempted[vseq.seq_id] = self._retire(victim, "preempted")
                if victim == slot:
                    seq = None       # preempted itself; stop growing it
        if preempted:
            self._rebuild_live()
        return preempted

    def step(self) -> StepResult:
        """Advance every live slot one token. Returns a `StepResult`:
        {seq_id: [token]} emitted this step, plus {seq_id: Retired} for
        the sequences that finished (eos | budget | cache_full |
        preempted; preempted ones yielded their blocks BEFORE the step and
        emit no token — requeue them)."""
        if not self._slots:
            return StepResult({}, {})
        t_step0 = time.perf_counter()
        preempted = self._ensure_blocks()
        if not self._slots:
            return StepResult({}, preempted)
        n_live_in = len(self._slots)
        self._sync_tables()
        self._decode_step()
        self._t += 1
        # THE step sync boundary: every slot's sampled token drains to the
        # host once per step
        sampled = self.tok.tolist()
        emitted: dict[int, list] = {}
        retired: dict[int, Retired] = dict(preempted)
        for slot in list(self._slots):
            seq = self._slots[slot]
            nxt = int(sampled[slot])
            seq.tokens.append(nxt)
            seq.n_new += 1
            seq.pos += 1
            emitted[seq.seq_id] = [nxt]
            reason = self._retire_reason(slot, nxt)
            if reason is not None:
                retired[seq.seq_id] = self._retire(slot, reason)
        # drop retired slots from the live mask (their table rows are
        # zeroed, so any residual write lands in the null block)
        if len(retired) > len(preempted):
            self._rebuild_live()
        n_emitted = len(emitted)
        self.flight.record(
            step=self._t,
            step_ms=round((time.perf_counter() - t_step0) * 1e3, 3),
            n_live=n_live_in, prefill_tokens=0, emitted=n_emitted,
            retired=len(retired) - len(preempted),
            blocks_in_use=self.block_pool.n_referenced,
            preemptions=len(preempted), drafted=0, accepted=0)
        return StepResult(emitted=emitted, retired=retired)

    def run(self, prompts, max_new_tokens,
            progress=None) -> list[list]:
        """Decode a whole batch of prompts with continuous batching: admit
        as slots (and blocks) free up, step until everything retires,
        REQUEUE preempted sequences at the head with their remaining
        budget. Returns prompt + generated tokens per input, in input
        order. `max_new_tokens` is a shared int or a per-prompt list (the
        serving parity tests replay mixed budgets offline through this
        path)."""
        budgets = (list(max_new_tokens)
                   if isinstance(max_new_tokens, (list, tuple))
                   else [max_new_tokens] * len(prompts))
        assert len(budgets) == len(prompts)
        pending = [(i, p, b) for i, p, b in
                   zip(range(len(prompts)), prompts, budgets)]
        results: dict[int, list] = {}
        generated: dict[int, int] = dict.fromkeys(range(len(prompts)), 0)
        idx_for: dict[int, int] = {}
        while pending or self._slots:
            while pending and self.free_slots:
                i, p, b = pending[0]
                try:
                    adm = self.admit(p, b)
                except NoFreeBlocks:
                    assert self._slots, \
                        "pool exhausted with no live sequence to retire"
                    break                      # step; retirements free blocks
                pending.pop(0)
                idx_for[adm.seq_id] = i
                if adm.retired is not None:  # finished at prefill
                    results[i] = adm.retired.tokens
            t0 = time.perf_counter()
            if self._slots:
                for sid, ret in self.step().retired.items():
                    i = idx_for.pop(sid)
                    generated[i] += len(ret.tokens) - ret.prompt_len
                    if ret.reason == "preempted":
                        # resume later from the retained prefix blocks:
                        # resubmit everything so far as the new prompt
                        pending.insert(0, (i, ret.tokens,
                                           budgets[i] - generated[i]))
                    else:
                        results[i] = ret.tokens
            if progress is not None:
                progress(self.n_live, time.perf_counter() - t0)
        return [results[i] for i in range(len(prompts))]
