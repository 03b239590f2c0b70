"""Block-paged attention-KV layout: a page pool plus a page table.

Port of ``repro.models.paged``. A dense serving cache gives every batch slot
a private ``capacity``-long K/V buffer; the paged layout replaces those
buffers with ONE physical page pool per layer group:

    dense:  k  (n_groups, n_slots, capacity, KV, hd)
    paged:  k  (n_groups, n_pages, page_size, KV, hd)

plus a per-slot page table, a ``(n_slots, P)`` int32 tensor mapping each
slot's logical page ``p`` (positions ``p * page_size ..``) to a physical
page. The table is kept on the host (``runtime.paged_cache`` and the
engine's ``_GroupPaging``) and rides every decode and verify call as an
operand, so remapping pages builds nothing new, and two slots whose prompts
share a full-page prefix point their first table entries at the same
physical pages.

Only attention K/V (and the int8 scales) are paged. SSM conv tails and
state have no sequence axis and stay per slot, so consumers dispatch on the
leaf name (``is_paged_key``).

Exactness: a slot's gathered view ``pool[table[b]]`` reshaped to
``(P * page_size, KV, hd)`` holds the dense buffer's first columns wherever
the dense buffer was written; every other column sits at a masked position,
whose probability is exactly zero. So paged and dense decoding give
identical tokens, which the engine tests assert.

Compile keys: the table's width P is a shape, so ``PagedLayout.buckets``
quantizes widths to a power-of-two ladder and each bucket is one step
callable. Sliding-window configs use one fixed bucket (the rolling buffer
never grows past ``window // page_size`` pages). As in the rest of the
port, cache updates happen in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import dtype_of, resolve_device
from repro_torch.models import ssm as SSM

# Cache leaf names that live in the page pool.
_PAGED_KEYS = ("k", "v", "k_scale", "v_scale")


def is_paged_key(name: str) -> bool:
    return name in _PAGED_KEYS


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static description of a block-paged KV cache.

    ``page_size``: tokens per physical page. ``n_pages``: physical pages in
    the pool, or None to size for the worst case (every slot at full
    length, plus one scratch page per slot; see ``pool_pages``).
    """

    page_size: int
    n_pages: Optional[int] = None

    def validate(self, cfg: ModelConfig, capacity: int) -> None:
        ps = self.page_size
        if ps <= 0:
            raise ValueError(f"kv page size must be positive, got {ps}")
        if capacity % ps:
            raise ValueError(
                f"kv page size {ps} must divide the cache capacity {capacity}")
        if cfg.sliding_window and cfg.sliding_window % ps:
            raise ValueError(
                f"kv page size {ps} must divide the sliding window "
                f"{cfg.sliding_window} (the rolling buffer wraps at page "
                f"boundaries)")
        if self.n_pages is not None and self.n_pages <= 0:
            raise ValueError(f"kv page pool must be positive, got {self.n_pages}")

    def seq_capacity(self, cfg: ModelConfig, capacity: int) -> int:
        """Cache positions per slot (the dense buffer's length)."""
        w = cfg.sliding_window
        return min(capacity, w) if w else capacity

    def cap_pages(self, cfg: ModelConfig, capacity: int) -> int:
        """Logical pages of a slot at full length (the widest table)."""
        return self.seq_capacity(cfg, capacity) // self.page_size

    def pool_pages(self, cfg: ModelConfig, batch: int, capacity: int) -> int:
        """Physical pool size: ``n_pages``, or every slot at full length
        plus (full attention only) one scratch page per slot that free
        slots' table rows point at, so that whole-batch launches write their
        garbage somewhere harmless."""
        if self.n_pages is not None:
            return self.n_pages
        scratch = 0 if cfg.sliding_window else 1
        return batch * (self.cap_pages(cfg, capacity) + scratch)

    def buckets(self, cfg: ModelConfig, capacity: int) -> Tuple[int, ...]:
        """Table widths that become compile keys, ascending: powers of two
        below the full-length page count, then that count; one fixed bucket
        under a sliding window."""
        cp = self.cap_pages(cfg, capacity)
        if cfg.sliding_window:
            return (cp,)
        out = []
        b = 1
        while b < cp:
            out.append(b)
            b *= 2
        out.append(cp)
        return tuple(out)

    def bucket_for(self, cfg: ModelConfig, capacity: int, needed: int) -> int:
        """Smallest bucket covering ``needed`` pages."""
        for b in self.buckets(cfg, capacity):
            if b >= needed:
                return b
        return self.cap_pages(cfg, capacity)


def init_paged_cache(cfg: ModelConfig, batch: int, capacity: int,
                     layout: PagedLayout, device=None):
    """Zeroed paged serving cache: the layout of
    ``init_decode_cache(per_slot=True)`` with every attention leaf a page
    pool ``(n_groups, n_pages, page_size, KV, hd)`` shared by all slots.
    ``pos`` stays the per-slot committed-token counter."""
    if cfg.is_encdec or cfg.frontend:
        raise NotImplementedError("paged cache supports token-only decoders")
    layout.validate(cfg, capacity)
    dev = resolve_device(device)
    dt = dtype_of(cfg.dtype)
    ps = layout.page_size
    n_pages = layout.pool_pages(cfg, batch, capacity)
    lead = (cfg.n_groups,)

    def one_layer(p: int):
        if cfg.layer_kind(p) != "attn":
            return SSM.init_ssm_cache(cfg, batch, dtype=dt, lead=lead,
                                      device=dev)
        shape = lead + (n_pages, ps, cfg.n_kv_heads, cfg.head_dim)
        if cfg.kv_quant:
            sc = shape[:-1] + (1,)
            return {
                "k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(sc, dtype=torch.bfloat16, device=dev),
                "v_scale": torch.zeros(sc, dtype=torch.bfloat16, device=dev),
            }
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}

    stack = {f"pos{p}": one_layer(p) for p in range(cfg.period)}
    pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
    return {"pos": pos, "stack": stack}


def paged_view(buf, pages, page_size: int):
    """Slot-major view of a page pool: buf (n_pages, page_size, ...), pages
    (B, P) -> (B, P * page_size, ...), a gathered copy; columns the table
    maps to pages the slot does not own hold garbage (masked by position).
    With ``pages`` None, ``buf`` is a dense cache and comes back as is."""
    if pages is None:
        return buf
    B, P = pages.shape
    g = buf[pages.long()]  # (B, P, page_size, ...)
    return g.reshape((B, P * page_size) + tuple(buf.shape[2:]))


def cache_rows(pages, slot, page_size: int):
    """Index of each slot's cache position ``slot`` ((B,) or (B, S)): the
    dense cache's (slot, position), or with the table ``pages`` (B, P) the
    pool's (physical page, offset)."""
    if pages is None:
        bix = torch.arange(slot.shape[0], device=slot.device)
        return bix.view((-1,) + (1,) * (slot.dim() - 1)), slot
    pix = torch.div(slot, page_size, rounding_mode="floor")
    phys = torch.gather(pages.long(), 1, pix.view(slot.shape[0], -1))
    return phys.view(slot.shape), slot - pix * page_size


def adopt_paged_slot(cache, pre, slot, pages, write_mask, page_size: int):
    """Adopt a prefilled slot into a paged serving cache, in place.

    ``pre`` is a dense ``prefill(per_slot=True, slot=...)`` cache whose
    attention lanes cover at least ``len(pages) * page_size`` positions.
    Attention lanes are cut into pages and written to the physical pages
    ``pages`` (ncp,) where ``write_mask`` (ncp,) is True; pages already
    resident through the shared-prefix radix are not rewritten (the prefill
    recomputed the same K/V for them), which is what lets one physical page
    back many slots. SSM state and the position counter copy densely, as in
    ``adopt_cache_slot``."""
    ps = page_size
    pages = torch.as_tensor(pages, device=cache["pos"].device).long()
    m = torch.as_tensor(write_mask, dtype=torch.bool,
                        device=cache["pos"].device)
    ncp = pages.shape[0]
    dst = pages[m]
    for pname, layer in cache["stack"].items():
        pl = pre["stack"][pname]
        for kname, full in layer.items():
            new = pl[kname]
            if kname in _PAGED_KEYS:
                lane = new[:, slot, :ncp * ps]  # (G, ncp * ps, ...)
                seg = lane.reshape((lane.shape[0], ncp, ps)
                                   + tuple(lane.shape[2:]))
                full[:, dst] = seg[:, m].to(full.dtype)
            else:
                full[:, slot] = new[:, slot].to(full.dtype)
    cache["pos"][slot] = pre["pos"][slot]
    return cache


def copy_page(cache, src, dst):
    """Copy physical page ``src`` onto ``dst`` in every pooled leaf, in
    place: the copy-on-write step before a slot writes into a page another
    slot or the radix tree still maps."""
    for layer in cache["stack"].values():
        for k, a in layer.items():
            if k in _PAGED_KEYS:
                a[:, int(dst)] = a[:, int(src)]
    return cache
