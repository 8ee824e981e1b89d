"""reference python/paddle/v2/master/client.py:29 — the trainer-side
master client (set_dataset / next_record task loop)."""
from __future__ import annotations

import queue
import threading


class _Pump:
    """Background record prefetcher over a BOUNDED queue (role of the Go
    client's buffered record channel). The queue's maxsize is the
    backpressure: the thread blocks once `buf_size` records wait, so a
    slow trainer never buffers a whole pass in memory.

    Termination protocol: on natural end of pass, _EOP is enqueued (after
    an error, too — with the error kept for the consumer to re-raise). On
    stop(), the pump exits at the next queue-put, closing the records
    generator so the in-flight task lease is RELEASED to the master
    immediately rather than expiring."""

    _EOP = object()

    def __init__(self, records_fn, buf_size: int):
        self.q: "queue.Queue" = queue.Queue(maxsize=buf_size)
        self.stop = threading.Event()
        self.err = None
        self.exhausted = False
        self._gen = records_fn(should_stop=self.stop.is_set)
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        stopped = False
        try:
            for rec in self._gen:
                placed = False
                while not self.stop.is_set():
                    try:
                        self.q.put(rec, timeout=0.1)
                        placed = True
                        break
                    except queue.Full:
                        pass
                if not placed:
                    stopped = True
                    return
        except Exception as e:
            # keep it: a reader error must surface from next_record(), not
            # vanish with the daemon thread (it would read as end-of-pass)
            self.err = e
        finally:
            if stopped:
                try:
                    # releases the in-flight task lease (records() handles
                    # GeneratorExit with task_released)
                    self._gen.close()
                except Exception:
                    pass
            else:
                while not self.stop.is_set():
                    try:
                        self.q.put(_Pump._EOP, timeout=0.1)
                        break
                    except queue.Full:
                        pass

    def retire(self):
        """Stop the pump and discard whatever it already buffered. Cheap:
        the stop flag exits the pump at its next put, it does NOT stream
        the rest of the pass just to throw it away."""
        self.stop.set()
        while self.thread.is_alive():
            try:
                self.q.get(timeout=0.05)
            except queue.Empty:
                pass
        self.thread.join()


class client:
    """API-parity facade over distributed.master.MasterClient. The
    reference dials etcd to find the Go master; here `endpoints` is the
    master's own "host:port" (or (host, port)).

    `timeout_sec` and `buf_size` carry the reference ctypes client's
    semantics (client.py:25): timeout_sec is the dial + per-RPC deadline;
    buf_size > 0 prefetches up to that many records into a bounded queue
    from a background thread, overlapping record fetch with training
    compute."""

    def __init__(self, endpoints, timeout_sec: int = 5, buf_size: int = 0):
        from ...distributed.master import MasterClient

        self._client = MasterClient(addr=endpoints,
                                    timeout=float(timeout_sec) or None)
        self._buf_size = int(buf_size)
        self._records = None
        self._pump = None

    def _retire_pump(self):
        if self._pump is not None:
            self._pump.retire()
            self._pump = None

    def _start_pass(self):
        if self._buf_size > 0:
            self._pump = _Pump(self._client.records, self._buf_size)
        else:
            self._records = self._client.records()

    def set_dataset(self, paths):
        # a still-running pump from a previous dataset would keep leasing
        # (and discarding) tasks of the NEW dataset — stop it first
        self._retire_pump()
        self._client.set_dataset(list(paths))
        self._start_pass()

    def next_record(self):
        """One record (bytes), or None at end of pass (the reference's
        (None, -1) end condition collapsed to None; like the unbuffered
        path, repeated calls after the end keep returning None)."""
        if self._pump is not None:
            if self._pump.exhausted:
                return None
            rec = self._pump.q.get()
            if rec is _Pump._EOP:
                self._pump.exhausted = True
                if self._pump.err is not None:
                    raise self._pump.err
                return None
            return rec
        if self._records is None:
            raise RuntimeError("set_dataset() first")
        try:
            return next(self._records)
        except StopIteration:
            return None

    def paddle_start_get_records(self, pass_id):  # reference client.py:94
        self._retire_pump()
        if self._client.all_done():
            # previous pass fully consumed: re-queue its tasks (the Go
            # master rolls passes inside TaskFinished; this service makes
            # the roll explicit so all_done() can mark pass ends). When
            # records were abandoned mid-pass, their released leases are
            # back in todo and the CURRENT pass simply continues.
            self._client.new_pass()
        self._start_pass()

    def request_save_model(self, trainer_id, block_ms):
        """The reference asks the master which ONE trainer should save the
        model this pass; with the TCP master any caller may save — report
        yes for trainer 0, matching the single-writer intent."""
        return 1 if int(trainer_id) == 0 else 0

    def release(self):
        self._retire_pump()
        self._client.close()
