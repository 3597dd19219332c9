"""Background batch preparation (counterpart of `pdm_ssd_tpu/runtime/prefetch.py`).

The JAX package builds a voxel model's kernel maps on the host, and runs
that build on a worker thread so that it overlaps the device step. The port
builds the maps on the device (`models.get_host_prepare`), so what the train
and eval loops hand to the worker thread is the host side of a batch alone:
`trainer.to_device_batch`, the collated arrays moved to the rank's device.
The map build stays inline in the step, on the thread that launches the
step's kernels: it is device work with host reads of its sizes in between,
and on a second thread it would queue on the same default stream of the
card, so it would overlap nothing but its own Python. The copy a thread
makes is ordered before the step's kernels that read it by that one stream.
"""
from __future__ import annotations

import queue
import threading

_STOP = object()


def prefetch_batches(loader, host_prepare=None):
    """Yield `host_prepare(batch)` for each batch of `loader`, preparing
    ahead on a daemon thread. With no `host_prepare` this is a plain
    iteration (no thread).

    The thread keeps one batch ahead of the step: at most one prepared
    batch waits besides the one the consumer holds and the one in
    preparation, so a batch's device copy lives at most three steps.

    A consumer that abandons the generator mid-epoch leaves the daemon
    thread parked on a full queue until process exit: harmless for the
    train and eval loops, which always drain."""
    if host_prepare is None:
        yield from loader
        return
    q = queue.Queue(maxsize=1)

    def work():
        try:
            for b in loader:
                q.put(host_prepare(b))
        except BaseException as e:          # surfaced in the consumer
            q.put(e)
            return
        q.put(_STOP)

    threading.Thread(target=work, daemon=True).start()
    while True:
        item = q.get()
        if item is _STOP:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
