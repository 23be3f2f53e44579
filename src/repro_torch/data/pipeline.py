"""Sharded, prefetching, checkpointable token pipeline.

Sources:
- ``synthetic``: deterministic PRNG token stream (per-host, per-shard seeds)
- ``file``: memory-mapped token file (np.uint16/np.int32 raw), sharded by
  host and reshuffled per epoch with a stateless permutation

Large-scale properties:
- every host reads only its shard (host_id/num_hosts) — no shared-fs
  contention at 1000+ nodes;
- iterator state is two integers (epoch, step) + the config hash → restores
  exactly after preemption (recorded in every checkpoint);
- background prefetch thread keeps ``prefetch`` batches ready so the host
  never stalls the device step (straggler mitigation at the input layer).
"""

from __future__ import annotations

import dataclasses
import hashlib
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    num_hosts: int = 1
    host_id: int = 0
    source: str = "synthetic"  # synthetic | file
    path: str | None = None
    seed: int = 0
    prefetch: int = 2

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts

    def fingerprint(self) -> str:
        return hashlib.sha1(repr(self).encode()).hexdigest()[:12]


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.step = 0
        self.epoch = 0
        self._tokens = None
        if cfg.source == "file":
            raw = np.memmap(cfg.path, dtype=np.uint16, mode="r")
            shard = len(raw) // cfg.num_hosts
            self._tokens = raw[cfg.host_id * shard : (cfg.host_id + 1) * shard]
            self._per_epoch = max(
                1, (len(self._tokens) - 1) // (cfg.host_batch * cfg.seq_len)
            )
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- deterministic batch synthesis ------------------------------------------

    def _batch_at(self, epoch: int, step: int) -> dict:
        cfg = self.cfg
        if cfg.source == "synthetic":
            rng = np.random.default_rng(
                (cfg.seed, cfg.host_id, epoch, step)
            )
            toks = rng.integers(
                0, cfg.vocab, (cfg.host_batch, cfg.seq_len), dtype=np.int32
            )
            return {"tokens": toks}
        if cfg.source == "ramp":
            # learnable synthetic stream (next = cur + 1 mod vocab): lets
            # smoke tests assert a REAL loss decrease instead of noise
            rng = np.random.default_rng((cfg.seed, cfg.host_id, epoch, step))
            start = rng.integers(0, cfg.vocab, (cfg.host_batch, 1))
            toks = (start + np.arange(cfg.seq_len)[None, :]) % cfg.vocab
            return {"tokens": toks.astype(np.int32)}
        # file: stateless per-epoch permutation of contiguous windows
        rng = np.random.default_rng((cfg.seed, epoch))
        perm = rng.permutation(self._per_epoch)
        win = cfg.host_batch * cfg.seq_len
        start = perm[step % self._per_epoch] * win
        flat = np.asarray(self._tokens[start : start + win], dtype=np.int32)
        return {"tokens": flat.reshape(cfg.host_batch, cfg.seq_len)}

    # -- iterator with background prefetch -----------------------------------------

    def _fill(self):
        e, s = self.epoch, self.step
        while not self._stop.is_set():
            try:
                self._q.put(((e, s), self._batch_at(e, s)), timeout=0.1)
            except queue.Full:
                continue
            s += 1
            if self.cfg.source == "file" and s % self._per_epoch == 0:
                e += 1

    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._fill, daemon=True)
            self._thread.start()
        return self

    def next(self) -> dict:
        if self._thread is None:
            batch = self._batch_at(self.epoch, self.step)
            self._advance()
            return batch
        (e, s), batch = self._q.get()
        self.epoch, self.step = e, s
        self._advance()
        return batch

    def _advance(self):
        self.step += 1
        if self.cfg.source == "file" and self.step % self._per_epoch == 0:
            self.epoch += 1

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
            self._thread = None
        # drain
        while not self._q.empty():
            self._q.get_nowait()

    # -- checkpointable state ---------------------------------------------------

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "step": self.step,
                "fingerprint": self.cfg.fingerprint()}

    def load_state_dict(self, st: dict):
        assert st["fingerprint"] == self.cfg.fingerprint(), (
            "data config changed across restore; refusing silent skew"
        )
        self.stop()
        self.epoch, self.step = st["epoch"], st["step"]
