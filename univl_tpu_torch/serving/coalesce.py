"""Request coalescing for the caption service.

The port's own copy of ``univl_tpu/serving/coalesce.py``. A beam decode
costs the same for one clip as for a full batch (the generator always runs
its fixed batch; pad slots repeat the last row), so N concurrent one-clip
requests served one by one waste (B - 1) / B of every decode.

``CoalescingCaptionService`` keeps one dispatcher thread that drains the
request queue: whatever arrived while the device was busy is merged into
one decode (whole requests, up to the batch size in clips). A lone request
is dispatched at once, with no batching delay: the previous decode is the
batching window. Per-clip results do not depend on the grouping, since
every per-row operation of the decode depends only on that row.

Requests grouped into one decode fail together if the decode raises;
input is validated in the HTTP handler before it is queued
(``cli/serve.py:_decode_videos``), so a malformed request fails alone.
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional, Sequence

import numpy as np


class _Pending:
    __slots__ = ("videos", "transcripts", "event", "out", "err")

    def __init__(self, videos, transcripts):
        self.videos = videos
        self.transcripts = transcripts
        self.event = threading.Event()
        self.out: Optional[List[str]] = None
        self.err: Optional[BaseException] = None


_STOP = object()


class CoalescingCaptionService:
    """Wraps a CaptionService with the same thread-safe ``caption()``, merging
    concurrent requests into shared decode batches.

    ``device_lock``: an optional lock serializing all device work in the
    process (the server shares one between captioning and the retrieval
    index); held only around a decode, never while waiting for requests.
    """

    def __init__(self, service, max_batch: Optional[int] = None, max_queue: int = 1024,
                 device_lock: Optional[threading.Lock] = None):
        self._svc = service
        self._max = int(max_batch or service.batch_size)
        self._device_lock = device_lock
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._closed = False
        self._worker = threading.Thread(target=self._loop, name="caption-coalescer",
                                        daemon=True)
        self._worker.start()

    def caption(self, videos: Sequence[np.ndarray],
                transcripts: Optional[Sequence[str]] = None) -> List[str]:
        if self._closed:
            raise RuntimeError("CoalescingCaptionService is closed")
        if transcripts is not None and len(transcripts) != len(videos):
            raise ValueError(f"{len(transcripts)} transcripts for {len(videos)} videos")
        req = _Pending(list(videos), list(transcripts) if transcripts else None)
        self._q.put(req)
        # bounded wait: a request that races past the closed flag after the
        # worker's final drain would otherwise wait forever
        while not req.event.wait(1.0):
            if self._closed and not self._worker.is_alive():
                raise RuntimeError("CoalescingCaptionService is closed")
        if req.err is not None:
            raise req.err
        return req.out

    def close(self):
        # the flag first, so nothing new is queued behind the sentinel; the
        # dispatcher fails whatever is still queued, so no caller waits forever
        self._closed = True
        self._q.put(_STOP)
        self._worker.join(timeout=10)

    def _loop(self):
        carry: Optional[_Pending] = None
        stopping = False
        while True:
            first = carry if carry is not None else self._q.get()
            carry = None
            if first is _STOP:
                self._drain_closed()
                return
            group = [first]
            clips = len(first.videos)
            # merge whole requests that arrived while the device was busy, up
            # to one batch; one that would overflow is carried to the next
            # group in arrival order; an oversized request runs alone (the
            # service splits it)
            while clips < self._max:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _STOP:
                    # serve this group, then fail the rest and exit; never put
                    # the sentinel back (with a full queue that put would block
                    # this thread, the only consumer)
                    stopping = True
                    break
                if clips + len(nxt.videos) > self._max:
                    carry = nxt
                    break
                group.append(nxt)
                clips += len(nxt.videos)
            self._serve_group(group)
            if stopping:
                if carry is not None:
                    carry.err = RuntimeError("CoalescingCaptionService is closed")
                    carry.event.set()
                self._drain_closed()
                return

    def _drain_closed(self):
        """Fail the requests that raced past the closed flag: their callers wait."""
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                return
            if r is _STOP:
                continue
            r.err = RuntimeError("CoalescingCaptionService is closed")
            r.event.set()

    def _serve_group(self, group: List[_Pending]):
        vids = [v for r in group for v in r.videos]
        # transcripts=None and "" encode alike, so a mixed group is exact
        txts: Optional[List[str]] = None
        if any(r.transcripts is not None for r in group):
            txts = []
            for r in group:
                txts.extend(r.transcripts or [""] * len(r.videos))
        try:
            if self._device_lock is not None:
                with self._device_lock:
                    outs = self._svc.caption(vids, transcripts=txts)
            else:
                outs = self._svc.caption(vids, transcripts=txts)
            i = 0
            for r in group:
                r.out = outs[i: i + len(r.videos)]
                i += len(r.videos)
        except BaseException as e:  # every waiter gets the error; nothing is swallowed
            for r in group:
                r.err = e
        finally:
            for r in group:
                r.event.set()
