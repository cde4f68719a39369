"""Offline-search / deploy-time-lookup artifact cache (paper §4.2).

"The best optimized cubin found throughout the assembly game is written to
the file system, prefixed by GPU type, workload type etc., as the key to
lookup.  At deployment ... it invokes a lookup process instead of training."

Artifacts are TSASS text (round-trippable through the parser) plus a JSON
sidecar with measured cycles, the winning autotune config and provenance.

Format history:

* **v1** — flat files, no version field, no index.
* **v2** — versioned sidecars + a per-kernel ``index.json`` recording every
  cached config under its spec-hash key plus the *chosen* (autotune-best)
  config, so deploy-time lookup is a single index read.
* **v3** — the index grows a ``"scenarios"`` map: one chosen entry per
  scenario bucket (:mod:`repro_torch.sched.scenario`), keyed
  ``(kernel, target, scenario_bucket)``.  Sidecars carry the bucket.  The
  legacy ``"best"`` field doubles as the **default-scenario** entry, which
  is exactly how v2 indexes (and index-less v1 directories) load through:
  their single chosen config becomes the ``"default"`` bucket, and
  scenario-less lookups keep resolving it byte-identically.  Unknown
  versions and corrupt files still raise :class:`CacheVersionError`
  **loudly** instead of silently missing.

:class:`ScheduleCache` wraps the files with an in-memory LRU so repeated
``deploy()`` / serving lookups are O(1) dict hits, and adds
:meth:`ScheduleCache.dispatch` — the serve-time shim that resolves a
request shape to the nearest tuned bucket as a pure index lookup.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Union

from repro_torch.core.isa import Instruction, program_text
from repro_torch.core.parser import parse_program
from repro_torch.sched.scenario import (DEFAULT_BUCKET, MachineTarget, Scenario,
                                        bucket_of, nearest_bucket)

DEFAULT_CACHE_DIR = os.environ.get("REPRO_SCHED_CACHE", ".repro_cache")
# the legacy bare-string target name; new code addresses targets through
# scenario.MachineTarget / get_target (README migration note)
TARGET = "tpu-tsass-v1"
CACHE_VERSION = 3
_KNOWN_VERSIONS = (1, 2, 3)

ScenarioKey = Union[Scenario, str, None]


class CacheVersionError(RuntimeError):
    """A cache file exists but cannot be trusted (unknown version /
    malformed payload).  Deliberately loud: a silent miss would retrain and
    overwrite an artifact that may still be served elsewhere."""


def _target_name(target: Union[str, MachineTarget, None]) -> str:
    if target is None:
        return TARGET
    return target.name if isinstance(target, MachineTarget) else str(target)


@dataclasses.dataclass
class Artifact:
    kernel: str
    target: str
    config: Dict
    program: List[Instruction]
    baseline_cycles: float
    optimized_cycles: float
    meta: Dict
    scenario: Optional[str] = None          # bucket key; None = default

    @property
    def speedup(self) -> float:
        return self.baseline_cycles / max(self.optimized_cycles, 1.0)

    @property
    def bucket(self) -> str:
        return self.scenario or DEFAULT_BUCKET


def cache_key(kernel: str, target: Union[str, MachineTarget], config: Dict,
              scenario: ScenarioKey = None) -> str:
    """Content key of one (kernel, target, config, scenario-bucket) cell.
    Default-bucket keys are byte-identical to the pre-scenario (v2) keys,
    so existing on-disk artifacts stay addressable."""
    blob = {"k": kernel, "t": _target_name(target), "c": config}
    bucket = bucket_of(scenario)
    if bucket != DEFAULT_BUCKET:
        blob["s"] = bucket
    return hashlib.sha256(
        json.dumps(blob, sort_keys=True).encode()).hexdigest()[:16]


def _paths(cache_dir: str, kernel: str, target: Union[str, MachineTarget],
           config: Dict, scenario: ScenarioKey = None):
    key = cache_key(kernel, target, config, scenario)
    d = os.path.join(cache_dir, _target_name(target), kernel)
    return os.path.join(d, f"{key}.tsass"), os.path.join(d, f"{key}.json")


def _index_path(cache_dir: str, target, kernel: str) -> str:
    return os.path.join(cache_dir, _target_name(target), kernel, "index.json")


def _atomic_write(path: str, payload: str) -> None:
    # atomic writes: temp + rename (same discipline as the checkpointer)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
    with os.fdopen(fd, "w") as f:
        f.write(payload)
    os.replace(tmp, path)


def load_index(cache_dir: str, target, kernel: str) -> Optional[Dict]:
    """The kernel's spec-hash index, or ``None`` when never written (pure
    v1 directory).  Unknown index versions fail loudly."""
    path = _index_path(cache_dir, target, kernel)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        try:
            idx = json.load(f)
        except ValueError as e:
            raise CacheVersionError(f"corrupt cache index {path}: {e}") from e
    if idx.get("version") not in _KNOWN_VERSIONS:
        raise CacheVersionError(
            f"cache index {path} has unknown version {idx.get('version')!r}")
    return idx


def index_scenarios(idx: Dict) -> Dict[str, Dict]:
    """bucket -> chosen entry, migrating v2 on the fly: an index written
    before the scenario axis has only ``"best"``, which *is* its default
    bucket (that is the whole v2 -> v3 load-through contract)."""
    scen = dict(idx.get("scenarios", {}))
    if DEFAULT_BUCKET not in scen and "best" in idx:
        scen[DEFAULT_BUCKET] = idx["best"]
    return scen


# serializes the index read-modify-write below: concurrent optimize_many
# threads saving into one kernel's dir must not lose each other's entries
# (cross-process writers still race benignly — artifacts are content-
# addressed, only the index merge needs the lock)
_INDEX_LOCK = threading.Lock()


def _update_index(artifact: Artifact, cache_dir: str, best: bool) -> None:
    path = _index_path(cache_dir, artifact.target, artifact.kernel)
    with _INDEX_LOCK:
        try:
            idx = load_index(cache_dir, artifact.target, artifact.kernel)
        except CacheVersionError:
            idx = None                 # rebuild a corrupt index on write
        if idx is None:
            idx = {"version": CACHE_VERSION, "kernel": artifact.kernel,
                   "target": artifact.target, "entries": {}}
        idx["version"] = CACHE_VERSION
        key = cache_key(artifact.kernel, artifact.target, artifact.config,
                        artifact.scenario)
        idx.setdefault("entries", {})[key] = artifact.config
        bucket = artifact.bucket
        scen = idx.setdefault("scenarios", {})
        if DEFAULT_BUCKET not in scen and "best" in idx:
            scen[DEFAULT_BUCKET] = idx["best"]     # v2 migration on write
        entry = {"key": key, "config": artifact.config,
                 "optimized_cycles": artifact.optimized_cycles}
        if bucket != DEFAULT_BUCKET:
            entry["scenario"] = artifact.meta.get("scenario", {})
        if best or bucket not in scen:
            scen[bucket] = entry
        if bucket == DEFAULT_BUCKET and (best or "best" not in idx):
            # keep the legacy field in lockstep so pre-scenario readers
            # (and the v1-era tooling) still see the chosen config
            idx["best"] = {"key": key, "config": artifact.config,
                           "optimized_cycles": artifact.optimized_cycles}
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _atomic_write(path, json.dumps(idx, indent=2, sort_keys=True))


def save(artifact: Artifact, cache_dir: str = DEFAULT_CACHE_DIR,
         best: bool = True) -> str:
    """Write the artifact (v3 sidecar) and record it in the kernel's index
    under its scenario bucket.  ``best=True`` marks its config as the
    bucket's chosen one — the config ``deploy()`` resolves without
    re-running autotune."""
    tsass_path, json_path = _paths(cache_dir, artifact.kernel,
                                   artifact.target, artifact.config,
                                   artifact.scenario)
    os.makedirs(os.path.dirname(tsass_path), exist_ok=True)
    sidecar = {
        "version": CACHE_VERSION,
        "kernel": artifact.kernel, "target": artifact.target,
        "config": artifact.config,
        "baseline_cycles": artifact.baseline_cycles,
        "optimized_cycles": artifact.optimized_cycles,
        "meta": artifact.meta}
    if artifact.scenario:
        sidecar["scenario"] = artifact.scenario
    for path, payload in (
        (tsass_path, program_text(artifact.program) + "\n"),
        (json_path, json.dumps(sidecar, indent=2)),
    ):
        _atomic_write(path, payload)
    _update_index(artifact, cache_dir, best)
    return tsass_path


def load(kernel: str, target, config: Dict,
         cache_dir: str = DEFAULT_CACHE_DIR,
         scenario: ScenarioKey = None) -> Optional[Artifact]:
    """Load one artifact by (kernel, target, config, scenario).  Missing
    files are a miss (``None``); present-but-untrusted files raise."""
    tsass_path, json_path = _paths(cache_dir, kernel, target, config,
                                   scenario)
    if not (os.path.exists(tsass_path) and os.path.exists(json_path)):
        return None
    return _load_files(tsass_path, json_path)


def _load_files(tsass_path: str, json_path: str) -> Artifact:
    with open(json_path) as f:
        try:
            meta = json.load(f)
        except ValueError as e:
            raise CacheVersionError(
                f"corrupt cache sidecar {json_path}: {e}") from e
    version = meta.get("version", 1)   # v1 sidecars predate the field
    if version not in _KNOWN_VERSIONS:
        raise CacheVersionError(
            f"cache artifact {json_path} has unknown version {version!r}; "
            f"refusing to guess (supported: {_KNOWN_VERSIONS})")
    with open(tsass_path) as f:
        program = parse_program(f.read())
    return Artifact(kernel=meta["kernel"], target=meta["target"],
                    config=meta["config"], program=program,
                    baseline_cycles=meta["baseline_cycles"],
                    optimized_cycles=meta["optimized_cycles"],
                    meta=meta.get("meta", {}),
                    scenario=meta.get("scenario"))


class ScheduleCache:
    """Scenario-indexed artifact store with an in-memory LRU (format v3).

    ``lookup_best`` resolves a kernel's chosen config for one scenario
    bucket through its index — one file read the first time, a dict hit
    afterwards — which is what makes ``deploy()`` and serving free of
    ``autotune``/``Machine`` work.  ``dispatch`` adds the serve-time
    nearest-bucket resolution over the tuned buckets.  Returned artifacts
    carry a fresh ``program`` list, so callers may mutate their copy
    without poisoning the cache.
    """

    def __init__(self, cache_dir: str = DEFAULT_CACHE_DIR,
                 target: Union[str, MachineTarget] = TARGET,
                 lru_size: int = 64):
        self.cache_dir = cache_dir
        self.target = _target_name(target)
        self.lru_size = int(lru_size)
        self._lru: "OrderedDict[str, Artifact]" = OrderedDict()
        # (kernel, target, bucket) -> resolved chosen config
        self._best_cfg: Dict[tuple, Dict] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.disk_loads = 0
        self.fallbacks = 0        # serve-time baseline fallbacks (lowering)
        self.quarantined = 0      # corrupt files renamed *.quarantine

    # -- internals ----------------------------------------------------------

    def _lru_get(self, key: str) -> Optional[Artifact]:
        with self._lock:
            art = self._lru.get(key)
            if art is not None:
                self._lru.move_to_end(key)
                self.hits += 1
            return art

    def _lru_put(self, key: str, art: Artifact) -> None:
        with self._lock:
            self._lru[key] = art
            self._lru.move_to_end(key)
            while len(self._lru) > self.lru_size:
                self._lru.popitem(last=False)

    @staticmethod
    def _fresh(art: Artifact) -> Artifact:
        return dataclasses.replace(art, program=list(art.program),
                                   meta=dict(art.meta))

    def _target(self, target) -> str:
        return self.target if target is None else _target_name(target)

    # -- lookups ------------------------------------------------------------

    def lookup(self, kernel: str, config: Dict,
               scenario: ScenarioKey = None,
               target: Union[str, MachineTarget, None] = None
               ) -> Optional[Artifact]:
        """Artifact for an explicit (kernel, config, scenario) cell,
        LRU-first."""
        tgt = self._target(target)
        key = cache_key(kernel, tgt, config, scenario)
        art = self._lru_get(key)
        if art is not None:
            return self._fresh(art)
        art = load(kernel, tgt, config, self.cache_dir, scenario)
        if art is None:
            with self._lock:
                self.misses += 1
            return None
        self.disk_loads += 1
        self._lru_put(key, art)
        return self._fresh(art)

    def best_config(self, kernel: str, scenario: ScenarioKey = None,
                    target: Union[str, MachineTarget, None] = None
                    ) -> Optional[Dict]:
        """The chosen config of one (kernel, scenario-bucket) cell,
        memoized after the first index read (refreshed by
        ``put(best=True)``; external index rewrites need a fresh
        ScheduleCache to be seen)."""
        tgt = self._target(target)
        bucket = bucket_of(scenario)
        memo_key = (kernel, tgt, bucket)
        cfg = self._best_cfg.get(memo_key)
        if cfg is not None:
            return cfg
        idx = load_index(self.cache_dir, tgt, kernel)
        if idx is not None:
            entry = index_scenarios(idx).get(bucket)
            if entry is not None:
                cfg = entry["config"]
                self._best_cfg[memo_key] = cfg
                return cfg
        return None

    def scenario_buckets(self, kernel: str,
                         target: Union[str, MachineTarget, None] = None
                         ) -> List[str]:
        """The tuned buckets of a kernel (index read; v2 indexes and
        single-artifact v1 directories surface as the default bucket)."""
        tgt = self._target(target)
        idx = load_index(self.cache_dir, tgt, kernel)
        if idx is not None:
            return sorted(index_scenarios(idx))
        if self._v1_single_stem(kernel, tgt) is not None:
            return [DEFAULT_BUCKET]
        return []

    def lookup_best(self, kernel: str, scenario: ScenarioKey = None,
                    target: Union[str, MachineTarget, None] = None
                    ) -> Optional[Artifact]:
        """The chosen artifact of one (kernel, scenario-bucket) cell via
        the index — zero autotune, zero machine execution.  Exact bucket
        only (``dispatch`` does nearest-bucket).  Falls back to the
        directory listing for pure-v1 dirs when exactly one artifact
        exists (unambiguous); the resolved config is memoized either way,
        so repeated lookups are LRU hits."""
        tgt = self._target(target)
        cfg = self.best_config(kernel, scenario, tgt)
        if cfg is not None:
            return self.lookup(kernel, cfg, scenario, tgt)
        bucket = bucket_of(scenario)
        if bucket == DEFAULT_BUCKET:
            stem = self._v1_single_stem(kernel, tgt)
            if stem is not None:
                d = os.path.join(self.cache_dir, tgt, kernel)
                art = self._load_stem(d, stem)
                self._best_cfg[(kernel, tgt, DEFAULT_BUCKET)] = art.config
                self._lru_put(stem, art)
                return self._fresh(art)
        with self._lock:
            self.misses += 1
        return None

    def dispatch(self, kernel: str, scenario: ScenarioKey = None,
                 target: Union[str, MachineTarget, None] = None
                 ) -> Optional[Artifact]:
        """Serve-time dispatch: resolve the request's scenario to the
        *nearest* tuned bucket and return that bucket's chosen artifact —
        a pure index lookup (zero autotune / machine execution), falling
        back through the default bucket so pre-scenario caches keep
        serving.  ``None`` only when the kernel was never optimized."""
        tgt = self._target(target)
        bucket = nearest_bucket(self.scenario_buckets(kernel, tgt), scenario)
        if bucket is None:
            with self._lock:
                self.misses += 1
            return None
        return self.lookup_best(kernel, bucket, tgt)

    def _v1_single_stem(self, kernel: str, tgt: str) -> Optional[str]:
        d = os.path.join(self.cache_dir, tgt, kernel)
        if os.path.isdir(d):
            sidecars = sorted(f for f in os.listdir(d)
                              if f.endswith(".json") and f != "index.json")
            if len(sidecars) == 1:
                return sidecars[0][:-5]   # the stem IS the spec-hash key
        return None

    def _load_stem(self, d: str, stem: str) -> Artifact:
        self.disk_loads += 1
        return _load_files(os.path.join(d, f"{stem}.tsass"),
                           os.path.join(d, f"{stem}.json"))

    # -- writes -------------------------------------------------------------

    def put(self, artifact: Artifact, best: bool = True) -> str:
        path = save(artifact, self.cache_dir, best=best)
        key = cache_key(artifact.kernel, artifact.target, artifact.config,
                        artifact.scenario)
        self._lru_put(key, self._fresh(artifact))
        if best:
            self._best_cfg[(artifact.kernel, artifact.target,
                            artifact.bucket)] = artifact.config
        return path

    # -- quarantine ---------------------------------------------------------

    def quarantine_kernel(self, kernel: str,
                          target: Union[str, MachineTarget, None] = None
                          ) -> List[str]:
        """Rename this kernel's unreadable cache files to ``*.quarantine``
        so one corrupt artifact stops poisoning every load of the
        directory.  Direct :meth:`lookup`/:func:`load` calls still raise
        :class:`CacheVersionError` loudly on corrupt files — quarantine is
        an *explicit* recovery step, invoked by the serve shim's
        ``on_missing="baseline"`` policy (``sched.lowering``) after such a
        raise.  A quarantined sidecar takes its ``.tsass`` twin with it
        (and vice versa): a surviving half-artifact would be
        indistinguishable from a clean miss.  Returns the renamed paths.
        """
        tgt = self._target(target)
        d = os.path.join(self.cache_dir, tgt, kernel)
        renamed: List[str] = []

        def _quarantine(*paths: str) -> None:
            for p in paths:
                if os.path.exists(p):
                    os.replace(p, f"{p}.quarantine")
                    renamed.append(p)

        if os.path.isdir(d):
            try:
                load_index(self.cache_dir, tgt, kernel)
            except CacheVersionError:
                _quarantine(os.path.join(d, "index.json"))
            for f in sorted(os.listdir(d)):
                if not f.endswith(".json") or f == "index.json":
                    continue
                stem = f[:-5]
                json_path = os.path.join(d, f)
                tsass_path = os.path.join(d, f"{stem}.tsass")
                try:
                    _load_files(tsass_path, json_path)
                except (CacheVersionError, ValueError, KeyError, OSError):
                    _quarantine(json_path, tsass_path)
        with self._lock:
            self.quarantined += len(renamed)
            # drop memoized state that may point at quarantined files
            for k in [k for k in self._best_cfg if k[0] == kernel
                      and k[1] == tgt]:
                del self._best_cfg[k]
            self._lru.clear()
        return renamed

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "disk_loads": self.disk_loads, "lru_entries": len(self._lru),
                "fallbacks": self.fallbacks,
                "quarantined": self.quarantined}
