"""The hand-off of KV pages into a caller's paged pool on the device.

A stored page is page-first: ``(L, *row)``, every layer of its tokens. An
inference engine's pool is layer-first: ``(L, P, *row)``, a layer's slots
side by side (SGLang's MLA pool and FlashMLA's ``kcache`` are laid out so,
per layer, blocks x tokens x latent). Page ``i`` lands in ``out[:, s_i]``:
``L`` segments of one row each, ``P`` rows apart.

Pages land through staging that is reused from call to call, on whatever
thread: on the card, two page-locked buffers of ``STAGE_PAGES`` pages each,
laid out layer-first as ``(L, STAGE_PAGES, row)``. The host copies each page's layers into its
column of a buffer; each run of pages bound for consecutive slots then goes
to the card as ONE two-dimensional copy by the copy engine (``L`` rows of
``n`` pages' bytes, the staging's and the pool's pitches), so no kernel
runs and the card reads the staging by DMA. While one buffer's copies run
the host fills the other; a buffer is filled again only once its copies
are done, and ``land`` returns when every page is on the card.

On the CPU (the tests) the same staging and the same runs are copied with
``torch`` strided copies.
"""

from __future__ import annotations

import threading
from typing import List, Sequence, Tuple

import torch

#: pages a staging buffer holds (two buffers a thread a device)
STAGE_PAGES = 32


def runs(slots: Sequence[int]) -> List[Tuple[int, int, int]]:
    """[(first index, first slot, count)]: the maximal runs of ``slots``
    that name consecutive slots in order."""
    out: List[Tuple[int, int, int]] = []
    for i, s in enumerate(slots):
        if out and out[-1][1] + out[-1][2] == s:
            out[-1] = (out[-1][0], out[-1][1], out[-1][2] + 1)
        else:
            out.append((i, s, 1))
    return out


def copy2d(dst: torch.Tensor, dst_off: int, dpitch: int, src: torch.Tensor,
           src_off: int, spitch: int, width: int, height: int) -> None:
    """Copy ``height`` rows of ``width`` bytes from ``src`` (rows
    ``spitch`` bytes apart from byte ``src_off``) to ``dst`` (``dpitch``
    apart from ``dst_off``), both flat uint8. From host staging to the card
    it is one copy-engine transfer on the current stream (it returns once
    enqueued); on the CPU a strided copy."""
    if dst.device.type == "cuda":
        from tpu3fs_torch import kernels

        kernels.launch("tpu3fs_copy2d_h2d", dst.device,
                       dst.data_ptr() + dst_off, dpitch,
                       src.data_ptr() + src_off, spitch, width, height)
        return
    dst.as_strided((height, width), (dpitch, 1),
                   dst.storage_offset() + dst_off).copy_(
        src.as_strided((height, width), (spitch, 1),
                       src.storage_offset() + src_off))


class _Staging:
    """Two staging buffers, and the events that say when each buffer's
    copies are done."""

    def __init__(self, device: torch.device, nbytes: int):
        self.device = device
        self.bufs = [torch.empty(nbytes, dtype=torch.uint8,
                                 pin_memory=device.type == "cuda")
                     for _ in range(2)]
        self.events = [None, None]


class PageLander:
    """Lands pages into layer-first pools. A landing takes a free staging
    (or makes one: page-locking hundreds of MB takes seconds on some hosts)
    and gives it back when every page is there, so calls reuse the same
    staging whatever thread they run on, and concurrent calls each hold
    their own."""

    def __init__(self):
        self._mu = threading.Lock()
        self._free: List[_Staging] = []

    def _take(self, device: torch.device, nbytes: int) -> _Staging:
        with self._mu:
            for st in self._free:
                if st.device == device and st.bufs[0].numel() >= nbytes:
                    self._free.remove(st)
                    return st
            # a larger page on this device: the smaller stagings go
            self._free = [st for st in self._free if st.device != device]
        return _Staging(device, nbytes)

    def _give(self, st: _Staging) -> None:
        with self._mu:
            self._free.append(st)

    def land(self, pages: Sequence[torch.Tensor], out: torch.Tensor,
             slots: Sequence[int]) -> None:
        """Page ``i`` (a host tensor shaped ``out.shape[:1] +
        out.shape[2:]``, of ``out``'s dtype) into ``out[:, slots[i]]``.
        The caller has checked shapes, dtypes, slots and that ``out`` is
        contiguous."""
        if not pages:
            return
        row = out[0, 0].numel() * out.element_size()
        st = self._take(out.device, out.shape[0] * STAGE_PAGES * row)
        try:
            self._land(st, pages, out, slots)
        finally:
            self._give(st)

    def _land(self, st: _Staging, pages, out: torch.Tensor, slots) -> None:
        L, P = out.shape[0], out.shape[1]
        row = out[0, 0].numel() * out.element_size()
        C = STAGE_PAGES
        cuda = out.device.type == "cuda"
        dst = out.view(-1).view(torch.uint8)
        stream = torch.cuda.current_stream(out.device) if cuda else None
        for n, lo in enumerate(range(0, len(pages), C)):
            b = n % 2
            if st.events[b] is not None:
                st.events[b].synchronize()  # its last copies are done
            buf = st.bufs[b]
            stage = buf[:L * C * row].view(L, C, row)
            chunk = pages[lo:lo + C]
            for j, page in enumerate(chunk):
                stage[:, j].copy_(page.reshape(L, -1).view(torch.uint8))
            for j0, s0, count in runs(slots[lo:lo + len(chunk)]):
                copy2d(dst, s0 * row, P * row, buf, j0 * row, C * row,
                       count * row, L)
            if cuda:
                ev = torch.cuda.Event()
                ev.record(stream)
                st.events[b] = ev
        for b, ev in enumerate(st.events):
            if ev is not None:
                ev.synchronize()
                st.events[b] = None
