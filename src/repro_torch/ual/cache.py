"""Mapping cache: memoizes compile artifacts per ``(program, target)`` pair.

Modulo mapping dominates the toolchain's wall time (seconds to minutes per
kernel, with restarts), yet the suite compiles the same kernels onto the
same fabrics over and over.  The cache keys on
``(program.digest, target.digest)`` — both stable content hashes — and
keeps results in two layers:

  * an in-process dict (free hits within one run),
  * an on-disk pickle directory (hits across processes: test runs,
    benchmark re-runs, CI re-tries).

Two artifact kinds live side by side under the same key:

  * the ``MapResult`` (placements + machine configuration) from the
    mapping pass, and
  * the **lowered artifact** (``core.lowering.LinkedConfig`` dense
    tables) from the lowering pass — lower once, run many: a warm
    compile re-lowers nothing, and every backend executing the same
    configuration shares one set of tables.

Hit/miss/store counters are exposed for tests to assert cache behavior:
``cache.stats`` holds the raw ``CacheStats`` counters, and *calling* it —
``cache.stats()`` — returns the aggregate view (hit/miss ratios plus
on-disk entry counts for both the mapping and lowered tables).

The cache is thread-safe: one lock guards the in-process layers and the
counters, and ``lock_key(key)`` hands out a per-key compile lock so the
pipeline can double-check under it — two threads compiling the same
``(program, target)`` digest pair pay exactly one mapper run and one
lowering (the execution service leans on this when a cold tenant's first
requests arrive on several workers at once).

Disk entries are self-verifying: every file carries a magic tag and a
SHA-256 checksum over the pickled payload, written atomically with it.
A reader that finds a torn, truncated or bit-flipped entry (disk died
mid-write, an operator truncated the file, a fault-injection run
corrupted it on purpose) treats it as a miss, *quarantines* the file by
renaming it to ``<name>.corrupt`` — so the poisoned bytes can never be
re-read, but stay on disk for post-mortem — and recompiles.  Quarantine
counts surface per layer in the aggregate stats view.

The disk layer is additionally safe under multi-PROCESS use (the
``ClusterService`` worker pool shares one directory):

  * writes publish atomically — pickle to a per-writer tmp file, then
    ``os.replace`` into place — so a reader never sees a torn entry,
  * a concurrent writer winning the race is tolerated: if our own
    publish fails but the final path exists, someone else stored an
    equivalent artifact and we read it back instead of erroring,
  * ``process_lock_key(key)`` hands out a cross-process analogue of
    ``lock_key``: an ``fcntl.flock``-backed lock on a per-key ``.lock``
    file in the disk dir.  The pipeline's mapping pass takes it for cold
    compiles (and keeps it through lowering), so N worker *processes*
    racing on one cold tenant pay exactly one mapping + one lowering
    cluster-wide — the losers block, then read the winner's entry off
    disk.  Diskless caches get a no-op lock (thread-level protection
    still applies).

The disk layer defaults to ``$REPRO_TORCH_UAL_CACHE`` or
``artifacts/repro_torch/ual_cache`` next to the repo; pass
``MappingCache(disk_dir=None)`` for a purely in-process cache.  The
directory, the variable and the entry magic all differ from the JAX
package's cache: the two packages pickle different classes, so neither
may ever read the other's entries.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.lowering import LOWERING_VERSION, LinkedConfig
from repro_torch.core.mapper import MAPPER_VERSION, MapResult

#: bump to invalidate on-disk entries when the MapResult/MachineConfig
#: pickle format changes; mapper *behavior* changes are covered separately
#: by core.mapper.MAPPER_VERSION (also folded into the entry name)
#: (v2: entries carry a magic tag + SHA-256 payload checksum)
CACHE_VERSION = 2

#: on-disk entry envelope: MAGIC + 16-byte checksum prefix + pickle blob
_MAGIC = b"UALT\x02"
#: entry-name prefix: even a directory shared with the JAX package's cache
#: holds no file that both packages would open
_PREFIX = "torch_"
_CSUM_LEN = 16


def _pack_entry(payload: object) -> bytes:
    blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    return _MAGIC + hashlib.sha256(blob).digest()[:_CSUM_LEN] + blob


def _unpack_entry(raw: bytes) -> object:
    """Verify the envelope and unpickle; raises ``ValueError`` on a bad
    magic/length/checksum (torn write, truncation, bit flip) so the
    caller can quarantine the file instead of feeding pickle garbage."""
    hdr = len(_MAGIC) + _CSUM_LEN
    if len(raw) < hdr or not raw.startswith(_MAGIC):
        raise ValueError("bad cache entry header")
    csum, blob = raw[len(_MAGIC):hdr], raw[hdr:]
    if hashlib.sha256(blob).digest()[:_CSUM_LEN] != csum:
        raise ValueError("cache entry checksum mismatch")
    return pickle.loads(blob)


def default_cache_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_UAL_CACHE")
    if env:
        return Path(env)
    # src/repro_torch/ual/cache.py -> repo root / artifacts / repro_torch /
    # ual_cache, but only when we actually live in a source checkout; for an
    # installed package parents[3] is the Python prefix, which must not be
    # written to
    root = Path(__file__).resolve().parents[3]
    if (root / "pyproject.toml").exists() or (root / ".git").exists():
        return root / "artifacts" / "repro_torch" / "ual_cache"
    xdg = os.environ.get("XDG_CACHE_HOME", str(Path.home() / ".cache"))
    return Path(xdg) / "repro_torch_ual"


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    stores: int = 0
    disk_hits: int = 0
    # -- lowered-artifact layer (counted separately: a compile can hit the
    # mapping entry while still lowering cold, and tests assert each) ------
    lowered_hits: int = 0
    lowered_misses: int = 0
    lowered_stores: int = 0
    lowered_disk_hits: int = 0
    #: corrupt disk entries detected and renamed aside (both layers)
    quarantined: int = 0
    #: probe for on-disk entry counts, wired up by the owning
    #: ``MappingCache`` so the aggregate view can report them; a bare
    #: ``CacheStats`` (no owner) reports zero disk entries
    _disk_counts: Optional[Callable[[], Tuple[int, int]]] = field(
        default=None, repr=False, compare=False)

    def reset(self) -> None:
        self.hits = self.misses = self.stores = self.disk_hits = 0
        self.lowered_hits = self.lowered_misses = 0
        self.lowered_stores = self.lowered_disk_hits = 0
        self.quarantined = 0

    @staticmethod
    def _layer(hits: int, misses: int, stores: int, disk_hits: int,
               disk_entries: int) -> Dict[str, object]:
        total = hits + misses
        return {"hits": hits, "misses": misses, "stores": stores,
                "disk_hits": disk_hits, "lookups": total,
                "hit_ratio": round(hits / total, 4) if total else None,
                "disk_entries": disk_entries}

    def __call__(self) -> Dict[str, Dict[str, object]]:
        """Aggregate view (this is what ``MappingCache.stats()`` returns):
        per-layer hit/miss ratios and on-disk entry counts for both the
        mapping and lowered tables."""
        m_disk, l_disk = self._disk_counts() if self._disk_counts else (0, 0)
        return {
            "mapping": self._layer(self.hits, self.misses, self.stores,
                                   self.disk_hits, m_disk),
            "lowered": self._layer(self.lowered_hits, self.lowered_misses,
                                   self.lowered_stores,
                                   self.lowered_disk_hits, l_disk),
            "quarantined": self.quarantined,
        }


class _KeyFileLock:
    """Cross-process exclusive lock on one cache key, backed by
    ``fcntl.flock`` on a per-key ``.lock`` file in the cache's disk dir.

    Same acquire/release shape as ``threading.Lock`` so the pipeline can
    hold it across passes the way it holds the thread-level key lock.
    The lock file itself is never deleted (deleting a file other
    processes may be flocking reintroduces the race the lock exists to
    close); flock state dies with the fd, so a crashed holder never
    wedges the key.  Not reentrant — one acquire per compile.
    """

    def __init__(self, path: Path) -> None:
        self._path = path
        self._fd: Optional[int] = None

    def acquire(self) -> None:
        import fcntl
        self._path.parent.mkdir(parents=True, exist_ok=True)
        fd = os.open(self._path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
        except OSError:
            os.close(fd)
            raise
        self._fd = fd

    def release(self) -> None:
        import fcntl
        fd, self._fd = self._fd, None
        if fd is not None:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def __enter__(self) -> "_KeyFileLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


@dataclass
class MappingCache:
    disk_dir: Optional[Path] = field(default_factory=default_cache_dir)
    stats: CacheStats = field(default_factory=CacheStats)
    _mem: Dict[Tuple[str, str], MapResult] = field(default_factory=dict)
    _mem_lowered: Dict[Tuple[str, str],
                       Tuple[str, LinkedConfig]] = field(
        default_factory=dict)
    _lock: object = field(default_factory=threading.RLock, repr=False,
                          compare=False)
    _key_locks: Dict[Tuple[str, str], object] = field(default_factory=dict,
                                                      repr=False,
                                                      compare=False)

    def __post_init__(self) -> None:
        if self.disk_dir is not None:
            self.disk_dir = Path(self.disk_dir)
        self.stats._disk_counts = self._disk_entry_counts

    def _path(self, key: Tuple[str, str]) -> Path:
        pdig, tdig = key
        return (self.disk_dir /
                f"{_PREFIX}v{CACHE_VERSION}m{MAPPER_VERSION}_"
                f"{pdig[:20]}_{tdig[:20]}.pkl")

    def _lowered_path(self, key: Tuple[str, str]) -> Path:
        pdig, tdig = key
        return (self.disk_dir /
                f"{_PREFIX}v{CACHE_VERSION}m{MAPPER_VERSION}"
                f"l{LOWERING_VERSION}_{pdig[:20]}_{tdig[:20]}_low.pkl")

    def _read_entry(self, path: Path) -> Optional[object]:
        """Read + verify one disk entry; a torn/corrupt/stale file is
        quarantined (renamed to ``<name>.corrupt``) and reported as a
        miss — never an exception, never silently re-readable.  Caller
        holds ``self._lock``."""
        try:
            raw = path.read_bytes()
        except OSError:
            return None  # vanished/unreadable: plain miss
        try:
            return _unpack_entry(raw)
        except (ValueError, pickle.UnpicklingError, EOFError,
                AttributeError, ImportError, TypeError, IndexError):
            self.stats.quarantined += 1
            try:
                os.replace(path, path.with_name(path.name + ".corrupt"))
            except OSError:
                pass  # raced with another reader's quarantine: fine
            return None

    def _load(self, key: Tuple[str, str]
              ) -> Tuple[Optional[MapResult], bool]:
        """Memory-then-disk lookup, no counters; returns
        ``(result, from_disk)``.  Caller holds ``self._lock``."""
        if key in self._mem:
            return self._mem[key], False
        if self.disk_dir is not None:
            path = self._path(key)
            if path.exists():
                result = self._read_entry(path)
                if result is not None:
                    self._mem[key] = result
                    return result, True
        return None, False

    def get(self, key: Tuple[str, str]) -> Optional[MapResult]:
        with self._lock:
            result, from_disk = self._load(key)
            if result is None:
                self.stats.misses += 1
                return None
            self.stats.hits += 1
            if from_disk:
                self.stats.disk_hits += 1
            return result

    def peek(self, key: Tuple[str, str]) -> Optional[MapResult]:
        """``get`` without touching the hit/miss counters — the
        double-checked re-read under ``lock_key``, where a hit means
        "another thread just mapped this" rather than a warm compile."""
        with self._lock:
            return self._load(key)[0]

    def contains(self, key: Tuple[str, str]) -> bool:
        """Whether ``get(key)`` would hit (either layer), without touching
        the hit/miss counters — a peek for schedulers (``compile_many``)
        deciding what still needs to be mapped."""
        with self._lock:
            if key in self._mem:
                return True
            return self.disk_dir is not None and self._path(key).exists()

    def _write_atomic(self, path: Path, payload: object) -> None:
        """Publish ``payload`` at ``path`` atomically (tmp + os.replace),
        wrapped in the checksummed entry envelope.

        Runs OUTSIDE the cache lock — a slow disk store must not stall
        unrelated lookups.  Failures are tolerated when the final path
        exists (a concurrent writer won the race and published an
        equivalent artifact; the caller's in-memory copy is already
        installed); a failure with no entry on disk propagates — that is
        a real I/O problem, not a race."""
        self.disk_dir.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(
            f".tmp.{os.getpid()}.{threading.get_ident()}")
        try:
            tmp.write_bytes(_pack_entry(payload))
            os.replace(tmp, path)  # atomic: racers never read torn files
        except OSError:
            try:
                tmp.unlink()
            except OSError:
                pass
            if not path.exists():
                raise

    def lock_key(self, key: Tuple[str, str]) -> object:
        """The per-key compile lock: the pipeline's mapping and lowering
        passes serialize cold compiles of one digest pair under it
        (miss -> acquire -> ``peek`` again -> compute), so concurrent
        threads pay exactly one mapper run and one lowering per key."""
        with self._lock:
            lock = self._key_locks.get(key)
            if lock is None:
                lock = self._key_locks[key] = threading.Lock()
            return lock

    def process_lock_key(self, key: Tuple[str, str]
                         ) -> Optional[_KeyFileLock]:
        """Cross-PROCESS analogue of ``lock_key``: an un-acquired
        ``fcntl.flock``-backed lock on this key's ``.lock`` file, or
        None when there is no disk layer to coordinate over (or no
        ``fcntl`` on this platform).  The pipeline's mapping pass holds
        it across cold mapping + lowering so N processes sharing the
        disk dir pay exactly one of each per key — losers block, then
        read the winner's entry off disk."""
        if self.disk_dir is None:
            return None
        try:
            import fcntl                               # noqa: F401
        except ImportError:                            # pragma: no cover
            return None
        return _KeyFileLock(self._path(key).with_suffix(".lock"))

    def put(self, key: Tuple[str, str], result: MapResult, *,
            memory_only: bool = False) -> None:
        with self._lock:
            self._mem[key] = result
            self.stats.stores += 1
        if memory_only or self.disk_dir is None:
            return
        self._write_atomic(self._path(key), result)

    # -- lowered-artifact layer (same two-layer contract, same key) ---------
    # Entries are stored WITH the fingerprint of the configuration they
    # were lowered from: the wall-clock-budgeted mapper can produce
    # different configs for the same key (another process, a re-map after
    # a lost mapping pickle), and a mapping/lowered pair on disk may be
    # written by two racing compiles — a fingerprint mismatch is a miss,
    # never a silently-wrong artifact.
    def _load_lowered(self, key: Tuple[str, str], fingerprint: str
                      ) -> Tuple[Optional[LinkedConfig], bool]:
        """Memory-then-disk lowered lookup, no counters; returns
        ``(linked, from_disk)``.  Caller holds ``self._lock``."""
        entry = self._mem_lowered.get(key)
        if entry is not None:
            fp, linked = entry
            if fp == fingerprint:
                return linked, False
        elif self.disk_dir is not None:
            path = self._lowered_path(key)
            if path.exists():
                entry = self._read_entry(path)
                if (isinstance(entry, tuple) and len(entry) == 2
                        and entry[0] == fingerprint):
                    fp, linked = entry
                    self._mem_lowered[key] = (fp, linked)
                    return linked, True
        return None, False

    def get_lowered(self, key: Tuple[str, str],
                    fingerprint: str) -> Optional[LinkedConfig]:
        with self._lock:
            linked, from_disk = self._load_lowered(key, fingerprint)
            if linked is None:
                self.stats.lowered_misses += 1
                return None
            self.stats.lowered_hits += 1
            if from_disk:
                self.stats.lowered_disk_hits += 1
            return linked

    def peek_lowered(self, key: Tuple[str, str],
                     fingerprint: str) -> Optional[LinkedConfig]:
        """``get_lowered`` without counters (see ``peek``)."""
        with self._lock:
            return self._load_lowered(key, fingerprint)[0]

    def put_lowered(self, key: Tuple[str, str], linked: LinkedConfig,
                    fingerprint: str, *, memory_only: bool = False) -> None:
        with self._lock:
            self._mem_lowered[key] = (fingerprint, linked)
            self.stats.lowered_stores += 1
        if memory_only or self.disk_dir is None:
            return
        self._write_atomic(self._lowered_path(key), (fingerprint, linked))

    # -- aggregate view ------------------------------------------------------
    def _disk_entry_counts(self) -> Tuple[int, int]:
        """(mapping, lowered) entry counts on disk; (0, 0) when diskless."""
        if self.disk_dir is None or not Path(self.disk_dir).is_dir():
            return (0, 0)
        names = [p.name for p in Path(self.disk_dir).glob(f"{_PREFIX}*.pkl")]
        lowered = sum(1 for n in names if n.endswith("_low.pkl"))
        return (len(names) - lowered, lowered)

    def clear_memory(self) -> None:
        """Drop the in-process layer (disk entries survive) — lets tests
        exercise the cross-process path without spawning a process."""
        with self._lock:
            self._mem.clear()
            self._mem_lowered.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)


_default: Optional[MappingCache] = None


def default_cache() -> MappingCache:
    """The process-wide cache ``compile()`` uses when none is passed.
    Its aggregate stats join the metrics registry as the
    ``mapping_cache`` source (reads through this accessor, so swapping
    the default cache needs no re-registration)."""
    global _default
    if _default is None:
        from repro_torch import obs
        _default = MappingCache()
        obs.registry().register_source(
            "mapping_cache", lambda: default_cache().stats(), replace=True)
    return _default


def set_default_cache(cache: Optional[MappingCache]) -> MappingCache:
    """Swap the process-wide cache (e.g. a tmp-dir cache in tests);
    returns the previous one so callers can restore it."""
    global _default
    prev = default_cache()
    _default = cache
    return prev
