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
* **Chunked prefill fused into the step** (`prefill_chunk=N`, the
  reference's Sarathi-style path): admission is bookkeeping only; the
  prompt is split into <=N-token chunks and ONE chunk of the oldest
  partial prompt rides each step, before the decode forward of every live
  slot — one `paged_prefill_attn` launch per layer for the chunk, one
  `paged_decode_attn` per layer for the decode. Decode tokens have
  priority: a chunk takes the budget left after the live decode count,
  in whole blocks, at least one block. The chunk buffer is padded to N
  and written at a block-aligned offset; `table_width` adds N / bs slack
  columns so the padded tail of a prompt's last chunk writes only zero
  (null-block) entries. While a slot prefills it is PARKED: not live, its
  decode write position in the never-allocated last table column, so the
  step's decode write for it lands in the null block. Full blocks are
  published to the radix index as each chunk fills them; a mid-prefill
  preemption retires the partial with those blocks cached, so its resume
  is a prefix hit. `prefill_chunk=0` keeps the bucketed wave prefill.
* **int8 serving** (ops/quant.py): `cache_dtype='int8'` keeps int8 codes
  with fp32 scale pools (the `_q8` kernels read them);
  `quantize_weights=True` quantizes the weights once per engine and runs
  the DECODE forwards under the store — wave prefill and chunk forwards
  keep the model's own weights, as in the reference. MLA's latent cache
  declines int8 and keeps the model's dtype (`quant.quant_kv_usable`).
* **MLA** models page their latent cache (`c_kv` (n_blocks, bs, nlkv)
  and `k_r` (n_blocks, bs, 1, dhr) pools) through the same tables; their
  prefill, chunks and decode steps attend by weight absorption over the
  gathered logical view, with no paged kernel.
* **Self-speculative decoding** (`SPEC_DECODE=auto|on|off`, `SPEC_K`;
  the reference's :64-80): a host-side n-gram / prompt-lookup drafter
  (`ngram_propose`) proposes up to K tokens per live slot from the slot's
  own tokens, and ONE verify forward (`_spec_step`) runs the committed
  token + K drafts of every slot at its own position — a (n_slots, K+1)
  cached forward with every position's logits, `paged_update`'s multi-row
  write, then `paged_gather` and the naive attention with a per-slot
  offset (one slot: the paged prefill kernel) — accepts the longest draft
  prefix that matches the model's own greedy tokens and emits one
  correction token past it. Rejected rows sit past the new position,
  causally masked until later writes overwrite them. A step that runs a
  chunk never speculates, and a slot within K + 1 rows of `max_len`
  sends the whole step to the plain path (the position table's slice
  would clamp). Greedy only: at temperature > 0 the engine keeps the
  plain step.

Not ported yet (later slices): the host-RAM KV tier, the AOT program
store, meshes. `trace_guards` and `admit_traces` are empty dicts,
`fused_step_traces` 0 and `aot_store` None — eager PyTorch compiles no
programs — so the scheduler's trace and store gauges read 0.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from distributed_pytorch_tpu_torch.config import knob, resolve_gate
from distributed_pytorch_tpu_torch.models.generate import sample_token
from distributed_pytorch_tpu_torch.models.gpt import init_paged_cache
from distributed_pytorch_tpu_torch.obs.flight import FlightRecorder
from distributed_pytorch_tpu_torch.ops import quant
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


def ngram_propose(tokens, k: int, *, min_match: int = 2,
                  max_match: int = 4) -> list:
    """Host-side n-gram / prompt-lookup drafter (reference :243-263): find
    the most recent earlier occurrence of the sequence's current suffix
    n-gram (longest match first, n in [min_match, max_match]) and propose
    the up-to-k tokens that followed it. Returns [] on a miss (the slot
    rides the verify step with draft length 0, emitting exactly the plain
    step's token)."""
    L = len(tokens)
    if k <= 0 or L < min_match + 1:
        return []
    for n in range(min(max_match, L - 1), min_match - 1, -1):
        pattern = tokens[L - n:]
        for i in range(L - n - 1, -1, -1):
            if tokens[i:i + n] == pattern:
                cont = tokens[i + n:i + n + k]
                if cont:
                    return [int(t) for t in cont]
                break  # suffix-adjacent match with nothing after it
    return []


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
    advanced to the LIST of tokens it emitted, in stream order (one on a
    plain step; on a speculative step the accepted drafts and the
    correction token, cut after an EOS); `retired` holds the sequences
    that finished, including any preempted BEFORE the step ran (those
    emit no token). `prefill_tokens` counts the chunk's prompt tokens on a
    chunked step; `drafted` and `accepted` count this step's draft tokens
    and how many of them the verify accepted (0 on other steps)."""

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
                          # (for a partial slot: prefill rows written)
    blocks: list          # owned physical block ids, logical order
    order: int            # admission counter (preemption picks the max)
    # chunked prefill (prefill_chunk > 0): the suffix left to compute
    # after the prefix-cache hit and how much of it is in the cache;
    # suffix_done < len(suffix) marks the slot PARTIAL (parked)
    suffix: Optional[list] = None
    suffix_done: int = 0
    prefix_len: int = 0


class DecodeEngine:
    """Continuous batching over the paged KV cache: admit prompts (sharing
    any cached prefix), step all live slots at once, retire finished
    sequences, preempt-and-requeue when the pool runs dry.

    >>> eng = DecodeEngine(model, n_slots=8, temperature=0.0)
    >>> outs = eng.run(prompts, max_new_tokens=64)   # list of token lists

    The engine runs on `model`'s device, with a KV cache in the model's
    dtype, or int8 (`cache_dtype='int8'`; any other `cache_dtype` must be
    the model's own). `quantize_weights=True` runs the decode forwards on
    int8 weights. Paging knobs: `block_size` (KV rows per block, pow2;
    default 16 capped at `min_bucket` so the pow2 buckets stay
    block-aligned), `n_blocks` (pool size; default the slot cache's
    n_slots x max_len footprint plus the null block), `prefix_cache=False`
    disables content-addressed reuse. `prefill_chunk=N` (a multiple of
    `block_size`; pick N >= n_slots + block_size) fuses chunked prefill
    into the step; 0 keeps the wave prefill. `seed` seeds the sampling
    generator (on the model's device). `spec_decode` asks for speculative
    decoding with `spec_k` drafts (default the `SPEC_K` knob); the
    `SPEC_DECODE` knob overrides the request with 'on' / 'off', and a
    temperature above 0 or `spec_k` 0 keeps it off.

    The stable accounting surface a scheduler reads: `n_free`/`occupancy`
    /`retire_counts` plus `block_utilization`/`block_fragmentation`/
    `prefix_hit_rate`/`prefilled_tokens` (never the private `_slots`).
    """

    def __init__(self, model, *, n_slots: int = 8,
                 max_len: Optional[int] = None, cache_dtype=None,
                 quantize_weights: bool = False,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 eos_id: Optional[int] = None, seed: int = 0,
                 min_bucket: int = 16, block_size: Optional[int] = None,
                 n_blocks: Optional[int] = None, prefix_cache: bool = True,
                 prefill_chunk: int = 0,
                 spec_decode: Optional[bool] = None,
                 spec_k: Optional[int] = None):
        cfg = model.config
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.n_slots = n_slots
        self.max_len = max_len or cfg.block_size
        assert self.max_len <= cfg.block_size
        # int8 serving (ops/quant.py), as the caller asks
        if cache_dtype is not None and not isinstance(cache_dtype, str):
            cache_dtype = str(cache_dtype).removeprefix("torch.")
        if cache_dtype == "int8" and quant.quant_kv_usable(cfg):
            self.cache_dtype = torch.int8
        else:
            self.cache_dtype = model.dtype
            if cache_dtype and cache_dtype != "int8" and \
                    getattr(torch, cache_dtype) != model.dtype:
                raise ValueError(
                    f"cache_dtype {cache_dtype!r} differs from the model's "
                    f"{model.dtype}: build the model in that dtype")
        self.kv_quantized = self.cache_dtype == torch.int8
        self.weights_quantized = bool(quantize_weights)
        self.temperature = temperature
        self.top_k = top_k
        self.eos_id = eos_id
        self.min_bucket = min_bucket
        # greedy only: the verify compares argmax targets
        k = spec_k if spec_k is not None else knob("SPEC_K")
        self.spec_k = max(int(k), 0)
        self.spec_decode = (resolve_gate(knob("SPEC_DECODE"),
                                         bool(spec_decode))
                            and self.spec_k > 0 and temperature == 0.0)
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

        # chunked prefill: chunks are whole blocks, so every chunk writes
        # at a block-aligned offset (paged_update's prefill contract)
        if prefill_chunk:
            assert prefill_chunk % bs == 0 and prefill_chunk >= bs, (
                f"prefill_chunk {prefill_chunk} must be a positive "
                f"multiple of block_size {bs}")
            prefill_chunk = min(prefill_chunk, self.max_len)
        self.prefill_chunk = prefill_chunk
        # slack columns absorb the padded chunk buffer's overhang: the
        # last chunk of a prompt ending near max_len writes its whole
        # buffer, and the rows past the prompt must land in table entries
        # that exist AND are zero (null-block writes) — without the slack
        # paged_update's window would clamp back onto earlier blocks
        self.table_width = self.max_blocks + prefill_chunk // bs
        # partial slots park their decode write in the last table column,
        # which is never allocated, so it lands in the null block
        self._park_pos = (self.table_width - 1) * bs

        # weight-only int8: quantized once per engine; the decode forwards
        # run under it
        self._qparams = (quant.quantize_params(dict(model.named_parameters()))
                         if self.weights_quantized else None)

        self.caches = init_paged_cache(cfg, n_blocks, bs,
                                       dtype=self.cache_dtype,
                                       device=self.device)
        self.tok = torch.zeros(n_slots, dtype=torch.long, device=self.device)
        self.pos = torch.zeros(n_slots, dtype=torch.long, device=self.device)
        self.live = torch.zeros(n_slots, dtype=torch.bool, device=self.device)
        # host-mirrored block tables: rows of physical block ids per slot;
        # zeroed rows route dead-slot writes to the null block
        self._tables_h = np.zeros((n_slots, self.table_width), np.int32)
        self._tables_dirty = True
        self.block_tables = None
        self._sync_tables()

        self._slots: dict[int, _Slot] = {}     # slot index -> bookkeeping
        self._next_id = 0
        self._t = 0                            # global step counter
        # eager PyTorch compiles no programs: no retrace guards, no store
        self.trace_guards: dict = {}
        self.admit_traces: dict = {}
        self.fused_step_traces = 0
        self.aot_store = None
        # lifetime counters — the stable occupancy/accounting surface a
        # scheduler reads instead of poking _slots
        self.n_admitted = 0
        self.retire_counts = dict.fromkeys(RETIRE_REASONS, 0)
        self.prompt_tokens = 0        # prompt tokens across admissions
        self.prefix_hit_tokens = 0    # of those, served from cached blocks
        self.prefilled_tokens = 0     # suffix tokens actually prefilled
        self.emitted_tokens = 0       # tokens emitted across all steps
        self.spec_drafted_tokens = 0  # drafter proposals sent to verify
        self.spec_accepted_tokens = 0  # of those, accepted by the verify
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
        logits = self.model(padded, caches=self.caches, pos=prefix_len,
                            logits_idx=[len(suffix) - 1],
                            block_tables=self.block_tables[slot:slot + 1])
        first = self._sample(logits[:, -1, :])
        self.tok[slot] = first[0]
        self.pos[slot] = prefix_len + len(suffix)
        self.live[slot] = True
        return first

    @torch.no_grad()
    def _decode_step(self) -> None:
        """Advance every live slot by one token, on the int8 weights when
        the engine quantized them. Dead slots freeze their token and
        position; their zeroed table rows send the write to the null
        block, and parked slots' positions point at it."""
        with quant.use_quantized_params(self._qparams):
            logits = self.model(self.tok[:, None], caches=self.caches,
                                pos=self.pos,
                                block_tables=self.block_tables)
        nxt = self._sample(logits[:, -1, :])
        self.tok = torch.where(self.live, nxt, self.tok)
        self.pos = self.pos + self.live.long()

    @torch.no_grad()
    def _spec_step(self, draft: torch.Tensor,
                   dlen: torch.Tensor) -> torch.Tensor:
        """The speculative verify (reference `make_spec_step_fn`): ONE
        cached forward of every slot's committed token and its K drafts
        (n_slots, K+1) at the slot's own position, on the int8 weights
        when the engine quantized them; greedy targets at every position
        through `_sample`; the accept length is the longest draft prefix
        (within the slot's `dlen`) equal to the targets, and the correction
        token is the target right past it. Dead slots freeze their token
        and position and accept 0 (their zeroed table rows send the K+1
        writes to the null block). Returns the accept lengths (n_slots,)."""
        K = self.spec_k
        seq = torch.cat([self.tok[:, None], draft], dim=1)
        with quant.use_quantized_params(self._qparams):
            logits = self.model(seq, caches=self.caches, pos=self.pos,
                                block_tables=self.block_tables,
                                all_logits=True)           # (B, K+1, V)
        B = seq.shape[0]
        g = self._sample(logits.reshape(B * (K + 1), -1)).reshape(B, K + 1)
        valid = torch.arange(K, device=self.device)[None, :] < dlen[:, None]
        match = (draft == g[:, :K]) & valid
        acc = torch.cumprod(match.long(), dim=1).sum(dim=1)
        nxt = torch.gather(g, 1, acc[:, None])[:, 0]
        self.tok = torch.where(self.live, nxt, self.tok)
        acc = torch.where(self.live, acc, 0)
        self.pos = self.pos + torch.where(self.live, acc + 1, 0)
        return acc

    @torch.no_grad()
    def _chunk_forward(self, slot: int, chunk: list, off: int) -> None:
        """Prefill `chunk` (at most `prefill_chunk` tokens, padded to it)
        of the slot's prompt at the block-aligned offset `off`, on the
        model's own weights. Rows past the chunk are pads: they land in the
        slot's partial last block (overwritten before they are read) or in
        zero table entries (the null block). Samples the chunk's last row
        into `tok[slot]` — the first token when this is the prompt's last
        chunk; the decode step then leaves it alone (the slot is not live)."""
        buf = torch.tensor([chunk + [0] * (self.prefill_chunk - len(chunk))],
                           dtype=torch.long, device=self.device)
        logits = self.model(buf, caches=self.caches, pos=off,
                            logits_idx=[len(chunk) - 1],
                            block_tables=self.block_tables[slot:slot + 1])
        self.tok[slot] = self._sample(logits[:, -1, :])[0]

    # ------------------------------------------------------------------
    # host API
    # ------------------------------------------------------------------

    @property
    def free_slots(self) -> list[int]:
        return [s for s in range(self.n_slots) if s not in self._slots]

    @staticmethod
    def _is_partial(seq: _Slot) -> bool:
        """A chunked admission whose prompt is not all in the cache yet —
        parked out of the decode batch until its last chunk runs."""
        return seq.suffix is not None and seq.suffix_done < len(seq.suffix)

    def _live_slots(self) -> list[int]:
        """Slots decoding this step (occupied and not mid-prefill)."""
        return [s for s, seq in self._slots.items()
                if not self._is_partial(seq)]

    def _rebuild_live(self) -> None:
        mask = np.zeros((self.n_slots,), bool)
        mask[self._live_slots()] = True
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

    @property
    def accepted_token_rate(self) -> float:
        """Lifetime fraction of drafted tokens the verify accepted."""
        return (self.spec_accepted_tokens / self.spec_drafted_tokens
                if self.spec_drafted_tokens else 0.0)

    @property
    def tokens_per_step(self) -> float:
        """Lifetime mean tokens emitted per step — the speculative
        multiplier on step throughput (1.0 when spec is off)."""
        return self.emitted_tokens / self._t if self._t else 0.0

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
        request queued and admits again after a retirement.

        With `prefill_chunk` set, admission is bookkeeping only: the slot
        is parked, the first chunk's blocks are reserved (NoFreeBlocks
        keeps its meaning), and the prompt is chunked into the following
        steps — `first_token` is None and arrives in `StepResult.emitted`
        when the last chunk runs."""
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
        if self.prefill_chunk:
            return self._admit_chunked(slot, toks, prefix_len, matched,
                                       max_new_tokens, seq_id)
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

    def _admit_chunked(self, slot: int, toks: list, prefix_len: int,
                       matched: list, max_new_tokens: int,
                       seq_id: Optional[int]) -> Admission:
        """Chunked-mode admission: no device forward. The slot is parked
        (not live, its write position in the never-allocated last table
        column) and only the first chunk's blocks are reserved; the rest
        are allocated chunk by chunk, so a long prompt never holds blocks
        for rows it has not written."""
        bs = self.block_size
        suffix = toks[prefix_len:]
        first_rows = prefix_len + min(self.prefill_chunk, len(suffix))
        new_ids = self.block_pool.alloc_many(
            max(-(-first_rows // bs) - len(matched), 0))
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
        self.pos[slot] = self._park_pos
        if seq_id is None:
            seq_id = self._next_id
        self._next_id = max(self._next_id, seq_id) + 1
        self._slots[slot] = _Slot(
            seq_id=seq_id, tokens=list(toks), prompt_len=len(toks), n_new=0,
            max_new=max_new_tokens, pos=prefix_len, blocks=blocks,
            order=self.n_admitted, suffix=suffix, prefix_len=prefix_len)
        self.n_admitted += 1
        self.prompt_tokens += len(toks)
        self.prefix_hit_tokens += prefix_len
        return Admission(seq_id=seq_id, first_token=None,
                         prefix_len=prefix_len, prefilled=len(suffix))

    def _next_chunk(self, preempted: dict) -> Optional[tuple[int, int]]:
        """This step's prefill work: the OLDEST partial prompt gets the
        token budget the live decode slots leave, in whole blocks, at
        least one block (a full slot table cannot starve prefill). Grows
        that slot's blocks to cover the chunk, preempting youngest-first
        when the pool is dry (the partial itself is often the youngest —
        then the next-oldest partial gets its turn). Returns (slot, take)
        or None; preemption victims land in `preempted`."""
        bs = self.block_size
        while True:
            partials = [(seq.order, slot) for slot, seq in
                        self._slots.items() if self._is_partial(seq)]
            if not partials:
                return None
            slot = min(partials)[1]
            seq = self._slots[slot]
            avail = self.prefill_chunk - len(self._live_slots())
            avail -= avail % bs
            avail = min(max(avail, bs), self.prefill_chunk)
            take = min(avail, len(seq.suffix) - seq.suffix_done)
            need = -(-(seq.prefix_len + seq.suffix_done + take) // bs)
            while slot in self._slots and len(seq.blocks) < need:
                blk = self.block_pool.alloc()
                if blk is None:
                    # the id first: _retire drops the slot
                    victim = self._pick_victim()
                    vseq = self._slots[victim]
                    preempted[vseq.seq_id] = self._retire(victim,
                                                          "preempted")
                    self._rebuild_live()
                    continue
                self._tables_h[slot, len(seq.blocks)] = blk
                seq.blocks.append(blk)
                self._tables_dirty = True
            if slot in self._slots:
                return slot, take

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
            # partial slots write no decode row; they grow per chunk
            if seq is not None and self._is_partial(seq):
                continue
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

    def _spec_drafts(self) -> Optional[tuple]:
        """Host-side drafting for one speculative step (reference
        :1388-1430): an (n_slots, K) draft buffer and per-slot draft
        lengths, or None when this step runs the plain path. Each slot's
        draft is clamped so that the emitted run (accepted + correction)
        cannot overshoot its budget or the cache (`n <= max_new - n_new -
        1`, `n <= max_len - pos - 1`); block lists grow to cover the
        deepest acceptable row, and a dry pool SHRINKS the draft instead
        of preempting (speculation never evicts live work). Any live slot
        within K + 1 rows of `max_len` sends the whole step to the plain
        path: `slice_rows` clamps a (B,) start near the table's end, which
        would mis-rotate all K+1 rows of that slot."""
        K = self.spec_k
        draft = np.zeros((self.n_slots, K), np.int64)
        dlen = np.zeros((self.n_slots,), np.int64)
        for slot in self._live_slots():
            seq = self._slots[slot]
            if seq.pos + K + 1 > self.max_len:
                return None              # position-table clamp hazard
            prop = ngram_propose(seq.tokens, K)
            n = min(len(prop), seq.max_new - seq.n_new - 1,
                    self.max_len - seq.pos - 1)
            while n > 0 and \
                    seq.pos + n >= len(seq.blocks) * self.block_size:
                blk = self.block_pool.alloc()
                if blk is None:
                    n = len(seq.blocks) * self.block_size - seq.pos - 1
                    break
                self._tables_h[slot, len(seq.blocks)] = blk
                seq.blocks.append(blk)
                self._tables_dirty = True
            if n > 0:
                draft[slot, :n] = prop[:n]
                dlen[slot] = n
        if not dlen.any():
            return None                  # nothing to verify: plain step
        return draft, dlen

    def step(self) -> StepResult:
        """Advance every live slot one token — or, on a speculative step
        (`spec_decode` on, drafts available), up to `spec_k` + 1 tokens —
        running one prefill chunk of the oldest partial prompt first when
        `prefill_chunk` is set (such a step never speculates). Returns a
        `StepResult`: {seq_id: [tokens]} emitted this step in stream order
        (including the first token of a prompt whose LAST chunk ran), plus
        {seq_id: Retired} for the sequences that finished (eos | budget |
        cache_full | preempted; preempted ones yielded their blocks BEFORE
        the step and emit no token — requeue them)."""
        if not self._slots:
            return StepResult({}, {})
        t_step0 = time.perf_counter()
        preempted = self._ensure_blocks()
        chunk = self._next_chunk(preempted) if self.prefill_chunk else None
        if not self._slots or (chunk is None and not self._live_slots()):
            return StepResult({}, preempted)
        n_live_in = len(self._live_slots())    # decoding slots this step
        # drafting may grow block lists, so it comes before the table sync
        spec = None
        if self.spec_decode and chunk is None:
            spec = self._spec_drafts()
        self._sync_tables()
        chunk_done = False
        if chunk is not None:
            slot_c, take = chunk
            seq_c = self._slots[slot_c]
            off = seq_c.prefix_len + seq_c.suffix_done
            chunk_done = seq_c.suffix_done + take == len(seq_c.suffix)
            self._chunk_forward(
                slot_c, seq_c.suffix[seq_c.suffix_done:seq_c.suffix_done
                                     + take], off)
        if spec is not None:
            draft_h, dlen_h = spec
            acc = self._spec_step(
                torch.from_numpy(draft_h).to(self.device),
                torch.from_numpy(dlen_h).to(self.device))
        else:
            self._decode_step()
        if chunk_done:
            # the prompt is in: the slot goes live with its first token,
            # where a wave admit would have left it
            self.pos[slot_c] = off + take
            self.live[slot_c] = True
        self._t += 1
        # THE step sync boundary: every slot's sampled token drains to the
        # host once per step (with the accept lengths on a speculative
        # step: one transfer, not two)
        if spec is not None:
            sampled, accepted_h = torch.stack([self.tok, acc]).tolist()
        else:
            sampled = self.tok.tolist()
        emitted: dict[int, list] = {}
        retired: dict[int, Retired] = dict(preempted)
        prefill_tokens = 0
        drafted = accepted = 0
        if chunk is not None:
            # host mirror of the chunk: progress the partial and publish
            # the blocks that just became full (first-writer-wins, so
            # re-publishing earlier ones is a no-op)
            prefill_tokens = take
            seq_c.suffix_done += take
            seq_c.pos = seq_c.prefix_len + seq_c.suffix_done
            self.prefilled_tokens += take
            full = min(seq_c.pos, len(seq_c.blocks) * self.block_size) \
                // self.block_size
            self._register_blocks(seq_c.tokens, full, seq_c.blocks)
        for slot in list(self._slots):
            seq = self._slots[slot]
            if self._is_partial(seq):
                continue                       # still parked: no token
            nxt = int(sampled[slot])
            if spec is not None:
                # the accepted drafts, then the correction token; an EOS
                # inside the span ends the stream at it (the device
                # position runs ahead, but the slot retires this step and
                # its zeroed table row makes the overshoot unreachable)
                acc_s = int(accepted_h[slot])
                toks = [int(t) for t in draft_h[slot, :acc_s]] + [nxt]
                if self.eos_id is not None and self.eos_id in toks:
                    toks = toks[:toks.index(self.eos_id) + 1]
                seq.pos += len(toks)
                accepted += acc_s
            else:
                toks = [nxt]
                if not (chunk_done and slot == slot_c):
                    seq.pos += 1               # the first token is unwritten
            seq.tokens.extend(toks)
            seq.n_new += len(toks)
            emitted[seq.seq_id] = toks
            reason = self._retire_reason(slot, toks[-1])
            if reason is not None:
                retired[seq.seq_id] = self._retire(slot, reason)
        # drop retired slots from the live mask (their table rows are
        # zeroed, so any residual write lands in the null block)
        if len(retired) > len(preempted):
            self._rebuild_live()
        n_emitted = sum(len(v) for v in emitted.values())
        self.emitted_tokens += n_emitted
        if spec is not None:
            drafted = int(dlen_h.sum())
            self.spec_drafted_tokens += drafted
            self.spec_accepted_tokens += accepted
        self.flight.record(
            step=self._t,
            step_ms=round((time.perf_counter() - t_step0) * 1e3, 3),
            n_live=n_live_in, prefill_tokens=prefill_tokens,
            emitted=n_emitted, retired=len(retired) - len(preempted),
            blocks_in_use=self.block_pool.n_referenced,
            preemptions=len(preempted), drafted=drafted, accepted=accepted)
        return StepResult(emitted=emitted, retired=retired,
                          prefill_tokens=prefill_tokens, drafted=drafted,
                          accepted=accepted)

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
