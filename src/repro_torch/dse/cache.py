"""Content-addressed on-disk mapping cache.

Keys are SHA-256 hashes of (DFG content, architecture, MapperConfig,
oracle tag) — computed by ``repro_torch.core.mapper.mapping_cache_key`` — and
values are ``MapResult.to_dict()`` JSON files, one per key, sharded by
the first two hex digits.  Writes are atomic (tempfile + ``os.replace``)
so a crashed or concurrent sweep never leaves a half-written entry, and
two processes racing on the same key both land a complete entry (last
replace wins — both wrote the same deterministic result).  A corrupt or
stale entry reads as a miss and is *quarantined*: moved aside into
``<root>/quarantine/`` rather than silently re-missed every sweep, so
the torn bytes stay available for post-mortem and the slot is free for
the re-solve's clean ``put``.  The cache makes repeated sweeps and the
CI smoke lane near-free: every hit skips the SAT solve entirely and
replays the stored mapping.

A copy of ``src/repro/dse/cache.py``.  The keys and the entry layout are
the JAX package's, so one cache directory serves both packages.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional, Tuple

SCHEMA = 1

#: subdirectory corrupt entries are moved into (never read as entries)
QUARANTINE_DIR = "quarantine"


class MappingCache:
    def __init__(self, root: str):
        self.root = root
        self.hits = 0
        self.misses = 0
        self.corrupt = 0
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key[:2], f"{key}.json")

    def lookup(self, key: str) -> Tuple[Optional[Dict], str]:
        """``(result, state)`` where state is ``"hit"``, ``"miss"`` or
        ``"corrupt"`` — the caller can attribute a quarantined entry
        (``FailureKind.CACHE_CORRUPT``) instead of seeing a bare miss."""
        path = self._path(key)
        try:
            with open(path) as fh:
                entry = json.load(fh)
            if entry.get("schema") != SCHEMA:
                raise ValueError("stale cache schema")
            result = entry["result"]  # before counting: may be corrupt
        except FileNotFoundError:
            self.misses += 1
            return None, "miss"
        except (ValueError, KeyError, OSError):
            # torn write / stale schema: move aside for post-mortem and
            # free the slot — the next put() stores a clean entry
            self.misses += 1
            self.corrupt += 1
            self._quarantine(path)
            return None, "corrupt"
        self.hits += 1
        return result, "hit"

    def get(self, key: str) -> Optional[Dict]:
        return self.lookup(key)[0]

    def _quarantine(self, path: str) -> None:
        qdir = os.path.join(self.root, QUARANTINE_DIR)
        try:
            os.makedirs(qdir, exist_ok=True)
            os.replace(path,
                       os.path.join(qdir, os.path.basename(path) + ".corrupt"))
        except OSError:
            # cross-device or permission trouble: fall back to dropping it
            try:
                os.remove(path)
            except OSError:
                pass

    def put(self, key: str, result: Dict) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump({"schema": SCHEMA, "key": key, "result": result},
                          fh, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    def hit_ratio(self) -> float:
        """Session hit fraction (0.0 on an untouched cache) — the serving
        benchmark's cache-behavior metric."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> Dict:
        return {"dir": self.root, "hits": self.hits, "misses": self.misses,
                "corrupt": self.corrupt}

    def __len__(self) -> int:
        n = 0
        for dirpath, _, files in os.walk(self.root):
            if os.path.basename(dirpath) == QUARANTINE_DIR:
                continue
            n += sum(1 for f in files if f.endswith(".json"))
        return n
