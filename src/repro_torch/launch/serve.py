"""Batched serving driver — counterpart of `repro.launch.serve` (the
`Server` core): continuous batching over the packed serve parameters with
a paged KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve      # llama3.2-3b, w-ternary
    PYTHONPATH=src python -m repro_torch.launch.serve --policy ternary --impl mxu
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu --policy binary
    PYTHONPATH=src python -m repro_torch.launch.serve --policy w4a8 --impl planes
    PYTHONPATH=src python -m repro_torch.launch.serve --policy int8 --spec-draft planes:1 --spec-k 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b --policy het
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b --policy het \
        --spec-draft planes:1 --spec-k 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-32b --reduced --device cpu

The full-attention decoders are served: llama3.2-3b (the default),
qwen1.5-32b (QKV bias), nemotron-4-340b (squared ReLU, non-gated FFN) and
the MoE archs deepseek-moe-16b and phi3.5-moe-42b-a6.6b. Every
single-device precision policy of `core.precision.POLICIES` is served,
with the binary/ternary GEMMs in either formulation (`--impl
popcount|mxu`), the int4/int8 x int8 layers as stacked binary planes
(`--impl planes`), and self-speculative decoding (`--spec-draft
planes[:DEPTH] --spec-k K`); prompts of any length up to `cache_len`. An
MoE arch runs its weight-and-activation expert projections as one grouped
GEMM launch each (K11; under `--impl planes` and in the draft, K10 over the
expert stacks), with the reference's routing counters in `Server.stats`
(`moe_routed`, `moe_dropped`, `moe_expert_tokens`; a speculative tick
counts its verify step's rows and not the draft's).

What runs, as in the reference:
  * a fixed `slots` decode batch fed from a request FIFO; admission is
    metered by the page budget — a request waits until the free pages cover
    its whole lifetime plus every running request's remaining headroom, so
    mid-flight page allocation never fails
  * prefill per admitted request, right-padded to a power-of-two bucket
    (`default_buckets`), logits taken at the prompt's last real token; its
    KV is scattered into the slot's pages
  * one fused decode tick advances every active slot with a per-slot
    position vector (RoPE phase, write index and mask follow each slot's
    own clock); inactive rows decode token 0 at position 0 through an
    all-scratch page row
  * sampling on the host (`models.common.sample_token`: greedy, or a
    temperature draw keyed by (seed, token index)); greedy ticks take the
    argmax on the device and move only (slots,) ids
  * retirement at max_new, at EOS (the output cut at the first EOS), or
    when the cache is full, freeing the slot's pages
  * with `spec_draft`, each tick instead drafts up to spec_k-1 tokens per
    slot with the truncated-plane model, verifies them in one
    full-precision multi-token step, and keeps the longest prefix that
    matches what the full model samples: token-exact against sequential
    decode (`_spec_step`)
  * for an MoE arch, every prefill and decode call's routing counters are
    summed into `stats`; a decode tick routes (and counts) its idle rows
    too, as the reference's does; a speculative tick counts its verify
    step (every window row) and drops the draft's counters, since the
    verify step routes the same positions again

Not yet ported (asking for one raises): prefix sharing and copy-on-write,
preemption and swap, chunked prefill, mesh serving, the contiguous-slab
cache, and dispatch-ahead (the host schedules each tick after the previous
one has landed).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.precision import POLICIES
from repro_torch.launch import kv_cache
from repro_torch.launch.kv_cache import NULL_PAGE, PageTable, pages_for
from repro_torch.models import transformer
from repro_torch.models.common import ModelCtx, sample_token, tree_nbytes


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    temperature: float = 0.0   # 0 => greedy argmax
    seed: int = 0              # stateless sampling stream (with token index)
    eos: int | None = None     # stop token: retire the step it is sampled
    out: list = dataclasses.field(default_factory=list)


def default_buckets(lo: int, hi: int) -> tuple[int, ...]:
    """Powers-of-two prefill buckets in [lo, hi], always ending at hi."""
    out, b = [], max(lo, 1)
    while b < hi:
        out.append(b)
        b *= 2
    return tuple(out) + (hi,)


def _leaf_keys(tree) -> set:
    if isinstance(tree, dict):
        return set(tree) | {k for v in tree.values() for k in _leaf_keys(v)}
    if isinstance(tree, (list, tuple)):
        return {k for v in tree for k in _leaf_keys(v)}
    return set()


class Server:
    def __init__(self, cfg, params, *, slots: int = 4, cache_len: int = 256,
                 page_size: int = 32, num_pages: int | None = None,
                 ctx: ModelCtx | None = None, device=None,
                 spec_draft: str | None = None, spec_k: int = 4):
        self.device = resolve_device(device)
        if params["embed"]["w"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed']['w'].device}, "
                             f"the server runs on {self.device}")
        if any(k != "attn" for k in cfg.block_pattern):
            raise NotImplementedError("only full-attention decoders are ported "
                                      "(no exact-length prefill yet)")
        self.cfg = cfg
        self.sp = transformer.build_specs(cfg)
        self.params = params
        self.ctx = ctx or ModelCtx()
        self.slots = slots
        self.page_size = page_size
        if cache_len % page_size:
            cache_len += page_size - cache_len % page_size
        self.cache_len = cache_len
        self.buckets = default_buckets(page_size, cache_len)
        self.max_pages = cache_len // page_size
        if num_pages is None:
            num_pages = slots * self.max_pages + 1   # +1: scratch page 0
        self.pt = PageTable(num_pages, page_size, slots, self.max_pages)
        # the pool holds what prefill/decode store: the compute dtype,
        # unless the int8-requant cache is configured
        kv_dtype = None if cfg.kv_cache_dtype == "int8" else self.ctx.dtype
        self.cache = transformer.init_cache(cfg, num_pages, page_size,
                                            kv_dtype=kv_dtype, device=self.device)
        self.slot_req: list[Request | None] = [None] * slots
        self.slot_pos = np.zeros(slots, np.int32)
        self.queue: list[Request] = []
        self.completed: list[Request] = []
        self.pos_trace: list[np.ndarray] = []   # per-tick active-slot positions
        self.stats = {"prefills": 0, "decode_ticks": 0, "peak_pages": 0,
                      "spec_ticks": 0, "spec_proposed": 0, "spec_accepted": 0,
                      "spec_emitted": 0}
        if cfg.n_experts:
            # routing telemetry: prefill/decode return the counters too.
            # moe_routed: top-k assignments (kept + dropped);
            # moe_expert_tokens[e]: the assignments expert e served
            self.ctx = dataclasses.replace(self.ctx, moe_stats=True)
            self.stats.update({"moe_routed": 0, "moe_dropped": 0,
                               "moe_expert_tokens": [0] * cfg.n_experts})
        self._init_spec(cfg, params, spec_draft, spec_k)

    def _init_spec(self, cfg, params, spec_draft, spec_k):
        """Self-speculative decoding: a truncated-bit-plane DRAFT over the
        same packed weights and pages proposes spec_k-1 tokens per tick, one
        full-precision multi-token VERIFY step checks them. Acceptance is an
        exact match with what the full model samples, never a distribution
        test, so the output is token-exact against sequential decode."""
        self.spec = bool(spec_draft)
        self.spec_k = int(spec_k)
        self.spec_planes = 1
        self.draft_ctx = None
        if not self.spec:
            return
        kind, _, depth = spec_draft.partition(":")
        if kind != "planes":
            raise ValueError(f"unknown --spec-draft kind {kind!r} "
                             "(only 'planes[:DEPTH]' exists)")
        self.spec_planes = int(depth) if depth else 1
        if self.spec_planes < 1:
            raise ValueError("--spec-draft planes:DEPTH needs DEPTH >= 1")
        if self.spec_k < 1:
            raise ValueError("--spec-k must be >= 1")
        if cfg.kv_cache_dtype == "int8":
            # verify rides the chunk attention path, and the int8 KV requant
            # is not byte-identical at chunk boundaries: decode sequentially
            # (the reference also falls back for window/recurrent archs,
            # which this server refuses outright)
            self.spec = False
            return
        # layers in a direct int4/int8 layout need the plane twin for the
        # draft to read; a policy without such layers drafts at full
        # precision (operating_point's per-layer fallback): exact, accepted
        leaves = _leaf_keys(params)
        if {"w_q", "w_q4"} & leaves and "w_planes" not in leaves:
            raise ValueError("--spec-draft needs the bit-plane weight twin; pack "
                             "with transformer.pack_for_serve(..., plane_twins=True)")
        # layers that resolve to a plane-composed cell contract to the
        # leading spec_planes MSB planes; every other layer runs as usual
        self.draft_ctx = dataclasses.replace(self.ctx, impl="planes",
                                             draft_planes=self.spec_planes)

    # -- routing counters --------------------------------------------------------

    def _pop_moe(self, res, count: bool = True):
        """Strip the routing counters off a serve entry point's result under
        ctx.moe_stats and add them to `stats`; no-op otherwise. `count=False`
        drops them instead: the speculative draft routes the positions that
        its verify step routes again, and counting both would book them
        twice. (The reference queues them for a later drain, to keep its
        dispatch-ahead overlap; this server syncs on every tick's sampling
        anyway.)"""
        if not self.ctx.moe_stats:
            return res
        *rest, st = res
        if not count:
            return tuple(rest)
        et = st["expert_tokens"].cpu().numpy()
        dropped = int(st["dropped"])
        self.stats["moe_dropped"] += dropped
        self.stats["moe_routed"] += int(et.sum()) + dropped
        self.stats["moe_expert_tokens"] = [
            a + int(b) for a, b in zip(self.stats["moe_expert_tokens"], et)]
        return tuple(rest)

    # -- request lifecycle -----------------------------------------------------

    def submit(self, req: Request):
        if len(req.prompt) > self.buckets[-1]:
            raise ValueError(f"prompt len {len(req.prompt)} exceeds max bucket "
                             f"{self.buckets[-1]}")
        need = pages_for(self._need_tokens(req), self.page_size)
        if need > self.pt.usable_pages:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.pt.usable_pages} usable; raise --num-pages or shrink "
                f"the request")
        self.queue.append(req)

    def _bucket(self, n: int) -> int:
        return next(b for b in self.buckets if b >= n)

    def _need_tokens(self, req: Request) -> int:
        """KV tokens this request can write over its whole lifetime."""
        return min(len(req.prompt) + max(req.max_new, 1) - 1, self.cache_len)

    def _sample(self, req: Request, logits_row) -> int:
        return sample_token(logits_row, req.temperature, req.seed, len(req.out))

    # -- admission -------------------------------------------------------------

    def _outstanding_demand(self) -> int:
        """Pages active slots may still claim (their reserved headroom)."""
        return sum(
            pages_for(self._need_tokens(r), self.page_size) - int(self.pt.held[s])
            for s, r in enumerate(self.slot_req) if r is not None)

    def _admission_ok(self, req: Request) -> bool:
        """Lifetime reservation: free pages must cover this request's whole
        lifetime plus every running request's remaining headroom."""
        lifetime = pages_for(self._need_tokens(req), self.page_size)
        return self.pt.free_pages - self._outstanding_demand() >= lifetime

    def _try_start(self, s: int) -> bool:
        """Prefill + admit the queue head into slot s (False: it must wait)."""
        req = self.queue[0]
        if not self._admission_ok(req):
            return False   # FIFO: the head waits for pages; no jumping
        self.queue.pop(0)
        n = len(req.prompt)
        scatter_ids = self.pt.admit(s, n)
        bucket = self._bucket(n)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = req.prompt
        logits, rc = self._pop_moe(transformer.prefill(
            self.params, torch.from_numpy(toks).to(self.device), self.sp,
            self.ctx, cache_len=self.cache_len, last_pos=[n - 1]))
        self.stats["prefills"] += 1
        req.out.append(self._sample(req, logits[0, -1].cpu().numpy()))
        pad = pages_for(bucket, self.page_size) - len(scatter_ids)
        if pad:
            scatter_ids = np.concatenate(
                [scatter_ids, np.full(pad, NULL_PAGE, np.int32)])
        kv_cache.scatter_prefill(self.cache, rc, scatter_ids, self.page_size)
        self.slot_req[s] = req
        self.slot_pos[s] = n
        return True

    def _admit(self):
        """Fill free slots from the FIFO head."""
        for s in range(self.slots):
            if self.slot_req[s] is not None:
                continue
            if not self.queue or not self._try_start(s):
                break

    # -- serving loop ----------------------------------------------------------

    def _retire(self):
        """Clear completed slots: out of budget, cache full, or EOS sampled."""
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            eos = req.eos is not None and req.eos in req.out
            if eos:
                del req.out[req.out.index(req.eos) + 1:]
            if (len(req.out) >= req.max_new or eos
                    or self.slot_pos[s] >= self.cache_len - 1):
                self.completed.append(req)
                self.pt.retire(s)
                self.slot_req[s] = None
                self.slot_pos[s] = 0

    def _prepare_pages(self, lookahead=None):
        """Extend every running slot's coverage through this tick's writes:
        [pos, pos+la), la = lookahead[slot] on a speculative tick (the draft
        and the verify step both write the whole range), else 1. Every
        position stays within the lifetime the admission reserved."""
        for s, req in enumerate(self.slot_req):
            if req is not None:
                la = 1 if lookahead is None else int(lookahead.get(s, 1))
                self.pt.extend(s, int(self.slot_pos[s]) + la)

    def _masked_table(self, live) -> np.ndarray:
        """The page table with every row but `live`'s on the scratch page."""
        table = self.pt.table.copy()
        idle = np.ones(self.slots, bool)
        idle[list(live)] = False
        table[idle] = NULL_PAGE
        return table

    def _pick(self, logits, reqs: dict, first: int = 0) -> np.ndarray:
        """Token of every row of (slots, T, V) logits for the slots in
        `reqs`: row t of slot s is token index len(out) + first + t. Greedy
        picks take the argmax on the device (ties to the lowest index, as
        sample_token's np.argmax) and move only the ids."""
        if not any(r.temperature > 0 for r in reqs.values()):
            return torch.argmax(logits, dim=-1).cpu().numpy()
        rows = logits.cpu().numpy()
        out = np.zeros(rows.shape[:2], np.int64)
        for s, r in reqs.items():
            for t in range(rows.shape[1]):
                out[s, t] = sample_token(rows[s, t], r.temperature, r.seed,
                                         len(r.out) + first + t)
        return out

    def _spec_step(self) -> bool:
        """One self-speculative tick: DRAFT up to spec_k-1 tokens per slot
        with the truncated-plane context, VERIFY them in one full-precision
        multi-token step, accept the longest exactly-matching prefix plus
        the first corrected token.

        Every accepted token is sampled (the same stateless (seed, index)
        draw) from verify logits computed over exactly the inputs the
        sequential path would have fed: row t consumes [last token, draft_0
        .. draft_{t-1}], and the accept loop reaches row t only when all
        those drafts matched. The draft decides how many rows are usable,
        never which tokens land.

        The pools are written in place, so the draft's reduced-precision K/V
        land in the real pool at [pos, pos+k_eff-1). Verify rewrites the
        whole range [pos, pos+k_eff) with exact K/V, layer by layer, before
        any of its reads, so no draft byte is ever read after this tick;
        positions past the accepted point are overwritten by the next tick
        before its reads reach them."""
        self._admit()
        self._retire()
        # per-slot window: never past the request budget or the final cache
        # slot (the _retire above leaves >= 1 for every running slot)
        keff = {s: max(1, min(self.spec_k, r.max_new - len(r.out),
                              self.cache_len - 1 - int(self.slot_pos[s])))
                for s, r in enumerate(self.slot_req) if r is not None}
        self._prepare_pages(lookahead=keff)
        self.stats["peak_pages"] = max(self.stats["peak_pages"],
                                       self.pt.usable_pages - self.pt.free_pages)
        active = sorted(keff)
        if active:
            self.pos_trace.append(self.slot_pos[active].copy())
            self._spec_tick(active, keff)
        self._retire()   # cuts a mid-window EOS before retiring
        return bool(self.queue or any(r is not None for r in self.slot_req))

    def _spec_tick(self, active, keff) -> None:
        dev = self.device
        reqs = {s: self.slot_req[s] for s in active}
        base = {s: int(self.slot_pos[s]) for s in active}
        table = self._masked_table(active)
        # -- draft: sequential truncated-plane decode steps over the slots
        # still inside their window
        drafts = {s: [] for s in active}
        cur = {s: reqs[s].out[-1] for s in active}
        for j in range(self.spec_k - 1):
            live = [s for s in active if j < keff[s] - 1]
            if not live:
                break
            tokens = np.zeros((self.slots, 1), np.int32)
            pos = np.zeros(self.slots, np.int32)
            for s in live:
                tokens[s, 0] = cur[s]
                pos[s] = base[s] + j
            dlogits, self.cache = self._pop_moe(transformer.decode_step(
                self.params, self.cache, torch.from_numpy(tokens).to(dev),
                torch.from_numpy(pos).to(dev), self.sp, self.draft_ctx,
                pages=torch.from_numpy(self._masked_table(live)).to(dev)),
                count=False)   # the verify step routes these positions again
            picks = self._pick(dlogits, {s: reqs[s] for s in live}, first=j)
            for s in live:
                drafts[s].append(int(picks[s, 0]))
                cur[s] = drafts[s][-1]
        # -- verify: one chunk step over [last token, drafts...] per slot,
        # writing exact K/V across the whole window before reading it
        tokens = np.zeros((self.slots, self.spec_k), np.int32)
        pos0 = np.zeros(self.slots, np.int32)
        nreal = np.zeros(self.slots, np.int32)
        for s in active:
            row = [reqs[s].out[-1]] + drafts[s]
            tokens[s, :len(row)] = row
            pos0[s] = base[s]
            nreal[s] = keff[s]
        tab = torch.from_numpy(table).to(dev)
        vlogits, self.cache = self._pop_moe(transformer.decode_verify(
            self.params, self.cache, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(pos0).to(dev), self.sp, self.ctx, read_pages=tab,
            write_pages=tab, nreal=torch.from_numpy(nreal).to(dev)))
        picks = self._pick(vlogits, reqs)
        self.stats["spec_ticks"] += 1
        for s in active:
            r = reqs[s]
            emitted, n_acc = [], 0
            for t in range(keff[s]):
                emitted.append(int(picks[s, t]))
                if t < len(drafts[s]):
                    if drafts[s][t] != emitted[-1]:
                        break
                    n_acc += 1
            self.stats["spec_proposed"] += len(drafts[s])
            self.stats["spec_accepted"] += n_acc
            self.stats["spec_emitted"] += len(emitted)
            r.out.extend(emitted)
            # exact K/V now covers the inputs of the emitted rows; the last
            # emitted token is fed at exactly this position next tick
            self.slot_pos[s] = base[s] + len(emitted)

    def step(self) -> bool:
        """One server tick: admit -> retire -> page work -> one fused decode
        over every slot -> sample the landed tokens -> retire. Returns
        whether work remains. A speculative server runs `_spec_step`."""
        if self.spec:
            return self._spec_step()
        self._admit()
        self._retire()
        self._prepare_pages()
        self.stats["peak_pages"] = max(self.stats["peak_pages"],
                                       self.pt.usable_pages - self.pt.free_pages)
        active = [s for s, r in enumerate(self.slot_req) if r is not None]
        if active:
            self.pos_trace.append(self.slot_pos[active].copy())
            reqs = [self.slot_req[s] for s in active]
            tokens = np.zeros((self.slots, 1), np.int32)
            pos = np.zeros(self.slots, np.int32)
            for s, r in zip(active, reqs):
                tokens[s, 0] = r.out[-1]
                pos[s] = self.slot_pos[s]
            # rows of idle slots point at the scratch page only
            table = self._masked_table(active)
            dev = self.device
            logits, self.cache = self._pop_moe(transformer.decode_step(
                self.params, self.cache, torch.from_numpy(tokens).to(dev),
                torch.from_numpy(pos).to(dev), self.sp, self.ctx,
                pages=torch.from_numpy(table).to(dev)))
            self.stats["decode_ticks"] += 1
            for s in active:
                self.slot_pos[s] += 1
            nxt = self._pick(logits, dict(zip(active, reqs)))
            for s, r in zip(active, reqs):
                r.out.append(int(nxt[s, 0]))
        self._retire()
        return bool(self.queue or any(r is not None for r in self.slot_req))

    def run(self) -> int:
        ticks = 0
        while self.queue or any(r is not None for r in self.slot_req):
            self.step()
            ticks += 1
        return ticks


#: precision policies whose every layer resolves to a ported GEMM cell
PORTED_POLICIES = tuple(POLICIES)

#: GEMM formulations (`--impl`) the port serves
PORTED_IMPLS = ("popcount", "mxu", "planes")

#: flags of reference features this port has not reached yet
_NOT_PORTED = ("prefix_share", "preempt", "chunk_tokens", "mesh",
               "contiguous", "dispatch_ahead")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b",
                    help="llama3.2-3b (default), qwen1.5-32b, nemotron-4-340b, "
                         "or an MoE arch: deepseek-moe-16b, "
                         "phi3.5-moe-42b-a6.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--policy", default=None,
                    help="precision policy (default: the arch's); every "
                         "policy of core.precision.POLICIES is ported")
    ap.add_argument("--impl", default="popcount",
                    choices=("popcount", "mxu", "planes"),
                    help="GEMM formulation: popcount (XNOR / gated XNOR), "
                         "mxu (unpack + int8 dot), or planes (int4/int8 x "
                         "int8 layers as stacked binary planes; other layers "
                         "run their default cell)")
    ap.add_argument("--page-size", type=int, default=32)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="pool size; < slots*cache_len/page_size oversubscribes "
                         "and admission throttles on the page budget")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop token id: a request retires the step this "
                         "token is sampled")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature (0 = greedy); "
                         "stateless rng keyed by (seed, token index)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    # reference features that are not ported yet: accepted so that asking
    # for one fails loudly instead of being ignored
    ap.add_argument("--prefix-share", action="store_true")
    ap.add_argument("--preempt", action="store_true")
    ap.add_argument("--chunk-tokens", type=int, default=0)
    ap.add_argument("--spec-draft", default=None, metavar="KIND[:DEPTH]",
                    help="self-speculative decoding: 'planes[:DEPTH]' drafts "
                         "with the leading DEPTH (default 1) bit-planes of "
                         "the int4/int8 layers; token-exact vs sequential")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="speculation window: up to K-1 drafted tokens plus "
                         "one verified token per tick")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--contiguous", action="store_true")
    ap.add_argument("--dispatch-ahead", action="store_true")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    asked = [f for f in _NOT_PORTED if getattr(args, f)]
    if args.impl not in PORTED_IMPLS:
        raise SystemExit(f"--impl {args.impl}: not yet ported to repro_torch "
                         f"(ported: {', '.join(PORTED_IMPLS)})")
    if asked:
        flags = ", ".join("--" + f.replace("_", "-") for f in asked)
        raise SystemExit(f"{flags}: not yet ported to repro_torch")
    cfg = get_config(args.arch)
    device = resolve_device(args.device)
    if args.reduced:
        cfg = cfg.reduced()
    if args.policy:
        cfg = dataclasses.replace(cfg, policy=args.policy)
    if cfg.policy not in PORTED_POLICIES:
        raise SystemExit(f"--policy {cfg.policy}: not yet ported to repro_torch "
                         f"(ported: {', '.join(PORTED_POLICIES)})")
    ctx = ModelCtx(dtype=torch.bfloat16 if device.type == "cuda" else torch.float32,
                   impl=args.impl)
    gen = torch.Generator(device=device).manual_seed(0)
    # block by block: the train layout of a full-depth MoE arch would not fit
    sparams, train_b = transformer.init_for_serve(
        cfg, gen, device,
        plane_twins=args.spec_draft is not None or args.impl == "planes")
    serve_b = tree_nbytes(sparams)
    print(f"packed weights: {train_b / 2**20:.1f} MiB -> {serve_b / 2**20:.1f} MiB "
          f"({train_b / serve_b:.1f}x smaller, policy={cfg.policy}, "
          f"impl={args.impl})")
    srv = Server(cfg, sparams, slots=args.slots, cache_len=args.cache_len,
                 page_size=args.page_size, num_pages=args.num_pages, ctx=ctx,
                 device=device, spec_draft=args.spec_draft, spec_k=args.spec_k)
    if args.spec_draft and not srv.spec:
        print(f"--spec-draft {args.spec_draft}: this configuration cannot verify "
              f"exactly (int8 KV pool); decoding sequentially")
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab,
                              size=(rng.integers(4, 17),)).astype(np.int32)
        srv.submit(Request(i, prompt, args.max_new, temperature=args.temperature,
                           seed=i, eos=args.eos_id))
    t0 = time.perf_counter()
    ticks = srv.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total_new = sum(len(r.out) for r in srv.completed)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    st = srv.stats
    print(f"served {len(srv.completed)} requests, {total_new} tokens, "
          f"{ticks} ticks ({st['decode_ticks']} decode, {st['prefills']} "
          f"prefills), {dt:.3f}s ({total_new / dt:.1f} tok/s on {where})")
    if srv.spec:
        print(f"speculative: {st['spec_ticks']} ticks, {st['spec_proposed']} "
              f"drafted, {st['spec_accepted']} accepted, {st['spec_emitted']} "
              f"emitted (--spec-draft {args.spec_draft}, --spec-k {srv.spec_k})")
    print(f"page pool: {srv.pt.usable_pages} usable pages x "
          f"{srv.pt.page_size} tokens, peak {st['peak_pages']} live, "
          f"{srv.pt.free_pages} free at exit")
    if cfg.n_experts:
        routed = max(st["moe_routed"], 1)
        et = st["moe_expert_tokens"]
        util = [f"{v / max(sum(et), 1):.2f}" for v in et]
        print(f"moe: dense expert dispatch, routed={st['moe_routed']} "
              f"dropped={st['moe_dropped']} (drop-rate "
              f"{st['moe_dropped'] / routed:.1%}), expert util {util}")
    return srv



if __name__ == "__main__":
    main()
