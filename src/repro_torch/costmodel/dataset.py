"""Cost-model dataset: memo measurements -> feature matrices.

The :class:`repro_torch.sched.backends.SharedMeasureMemo` accumulates
(fingerprint, permutation) -> cycles entries for every schedule a campaign
ever measured.  :class:`CostDataset.from_memo` exports that corpus into a
supervised-learning dataset: one row per measured schedule, whose features
are computed by a :class:`ProgramFeaturizer` shared with the search-time
:class:`repro_torch.costmodel.rankers.CostModelRanker` (train/serve skew is a
bug class this sharing rules out).

Feature design (DESIGN.md §2.3 discipline: *program-text information
only* — no machine-side latency tables; the model learns latency
thresholds from measurements):

* **aggregate embedding features** — the kernel-independent fixed-column
  prefix of :func:`repro_torch.core.embedding.embed_program` rows (wait bits,
  barrier indices, yield, stall, is-mem, predication), averaged plain and
  position-weighted (the weighting breaks the permutation invariance of a
  plain mean: two schedules of one kernel are the same multiset of rows);
* **schedule-order features** — stall prefix-sum statistics over the
  semaphore setter->waiter gaps (the scoreboard's wait cost is a function
  of exactly these gaps), register def->use stall shortfalls against the
  microbenchmarked ``analysis.stall_table`` (Algorithm 1's accumulation),
  a reuse-distance histogram over def->use position distances, and
  per-engine-class (DMA in/out, MXU, vector-memory) issue-gap statistics.

Splits are deterministic: each row hashes its (canonical timing records,
permutation) key, so the same schedule always lands on the same side —
across rebuilds, merges and processes — and never leaks from train to
eval.  Datasets serialize to a versioned ``.npz`` next to ``--memo-dir``
payloads; unknown versions fail loudly (:class:`CostModelVersionError`,
mirroring the cache/memo conventions).

Port of ``repro/costmodel/dataset.py``, numpy as the reference is: the
same features, splits and ``.npz`` format (``FEATURE_VERSION``), so a
dataset written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import zipfile
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import embedding
from repro_torch.core.analysis import Analysis, analyze
from repro_torch.core.isa import NUM_SEMAPHORES, Instruction, is_fixed_latency

# on-disk format for exported datasets (CostDataset.save/load).  Same
# loud-versioning convention as the schedule cache and measurement memo.
DATASET_FORMAT = "repro-cost-dataset"
DATASET_VERSION = 1
_KNOWN_DATASET_VERSIONS = (1,)

# bump when the featurizer's output layout changes: a model trained on
# version-N features must refuse version-M matrices
FEATURE_VERSION = 1


class CostModelVersionError(RuntimeError):
    """A persisted cost-model artifact (dataset ``.npz`` or model ``.npz``)
    is corrupt or from an unknown format version.  Deliberately loud, like
    ``CacheVersionError`` / ``MemoVersionError``."""


_GAP_EDGES = np.array([0.0, 2.0, 4.0, 8.0, 16.0, 32.0, np.inf])
_DIST_EDGES = np.array([1.0, 2.0, 4.0, 8.0, 16.0, 32.0, np.inf])
_CLASSES = ("CPYIN", "CPYOUT", "MXM", "VMEM")

# 2 globals + (plain + position-weighted) embedding-prefix means
# + semaphore-slack block (3 stats + 6-bin hist)
# + dependency block (3 stats + 6-bin reuse-distance hist)
# + 4 engine classes x 4 gap stats
FEATURE_DIM = (2 + 2 * (embedding.FIXED_FEATURES - 1)
               + (3 + len(_GAP_EDGES) - 1)
               + (3 + len(_DIST_EDGES) - 1)
               + 4 * len(_CLASSES))


class ProgramFeaturizer:
    """Schedule-order -> feature-vector map for one instruction list.

    Built once per kernel from the *baseline* program (so instruction
    identities match the game's ``id_at`` encoding); ``features(order)``
    then evaluates any permutation in O(n) numpy.  Shared by dataset
    export and by :class:`repro_torch.costmodel.rankers.CostModelRanker`.
    """

    feature_version = FEATURE_VERSION

    def __init__(self, program: Sequence[Instruction],
                 analysis: Optional[Analysis] = None,
                 stall_db: Optional[Dict[str, int]] = None):
        if analysis is None:
            analysis = analyze(program, stall_db)
        self.analysis = analysis
        self.n = len(program)
        emb = embedding.embed_program(program, analysis)
        # drop the validity column; keep only the kernel-independent prefix
        self._emb = emb[:, 1:embedding.FIXED_FEATURES].astype(np.float64)
        self._stall = np.array([max(1, ins.ctrl.stall) for ins in program],
                               np.float64)

        setters: List[List[int]] = [[] for _ in range(NUM_SEMAPHORES)]
        waiters: List[List[int]] = [[] for _ in range(NUM_SEMAPHORES)]
        for i, ins in enumerate(program):
            for s in (ins.ctrl.read_bar, ins.ctrl.write_bar):
                if s is not None:
                    setters[s].append(i)
            for s in ins.ctrl.wait_mask:
                waiters[s].append(i)
        self._setters = [np.array(s, np.int64) for s in setters]
        self._waiters = [np.array(w, np.int64) for w in waiters]

        # register def->use pairs with their Algorithm-1 minimum stall
        # (stall_table is microbenchmark output — program-side information)
        last_def: Dict[str, int] = {}
        prod: List[int] = []
        cons: List[int] = []
        min_st: List[float] = []
        for i, ins in enumerate(program):
            for reg in ins.uses or ():
                if reg.startswith("UR"):
                    continue
                j = last_def.get(reg)
                if j is None:
                    continue
                p = program[j]
                st = (analysis.stall_table.get(p.opcode, 0)
                      if is_fixed_latency(p.opcode) else 0) or 0
                prod.append(j)
                cons.append(i)
                min_st.append(float(st))
            for reg in ins.defs or ():
                last_def[reg] = i
        self._prod = np.array(prod, np.int64)
        self._cons = np.array(cons, np.int64)
        self._min_st = np.array(min_st, np.float64)

        self._class_ids = {}
        for name in _CLASSES:
            if name == "VMEM":
                ids = [i for i, ins in enumerate(program)
                       if ins.base in ("LDV", "STV")]
            else:
                ids = [i for i, ins in enumerate(program)
                       if ins.base == name]
            self._class_ids[name] = np.array(ids, np.int64)

    @property
    def feature_dim(self) -> int:
        return FEATURE_DIM

    @staticmethod
    def _gap_stats(gaps: np.ndarray, edges: np.ndarray) -> List[float]:
        """[log-count, log-mean, clipped-min] + normalized histogram."""
        nbins = len(edges) - 1
        if gaps.size == 0:
            return [0.0] * (3 + nbins)
        hist, _ = np.histogram(gaps, bins=edges)
        return ([np.log1p(gaps.size), np.log1p(gaps.mean()),
                 min(float(gaps.min()) / 16.0, 4.0)]
                + (hist / gaps.size).tolist())

    def features(self, order: Sequence[int]) -> np.ndarray:
        order = np.asarray(order, dtype=np.int64)
        n = self.n
        pos_of = np.empty(n, np.int64)
        pos_of[order] = np.arange(n)
        st = self._stall[order]
        prefix = np.concatenate(([0.0], np.cumsum(st)))

        feats: List[float] = [np.log1p(n), np.log1p(prefix[-1])]

        emb = self._emb[order]
        weight = (np.arange(n) + 1.0) / n
        feats.extend(emb.mean(axis=0).tolist())
        feats.extend((emb * weight[:, None]).mean(axis=0).tolist())

        # semaphore setter -> waiter stall gaps: for each waiter, the
        # accumulated stall since the latest setter issued before it (the
        # quantity the scoreboard's semaphore waits stall on)
        sem_gaps = []
        for s in range(NUM_SEMAPHORES):
            sp = np.sort(pos_of[self._setters[s]])
            wp = pos_of[self._waiters[s]]
            if sp.size == 0 or wp.size == 0:
                continue
            idx = np.searchsorted(sp, wp, side="left") - 1
            ok = idx >= 0
            if not ok.any():
                continue
            sem_gaps.append(prefix[wp[ok]] - prefix[sp[idx[ok]] + 1])
        g = (np.concatenate(sem_gaps) if sem_gaps
             else np.empty(0, np.float64))
        feats.extend(self._gap_stats(g, _GAP_EDGES))

        # register def->use: Algorithm-1 stall shortfall + reuse distances
        if self._prod.size:
            pp = pos_of[self._prod]
            cp = pos_of[self._cons]
            gap = prefix[cp] - prefix[pp]        # stalls from def to use
            short = np.maximum(0.0, self._min_st - gap)
            dist = np.abs(cp - pp).astype(np.float64)
            feats.append(np.log1p(short.sum()))
            feats.append(float((short > 0).mean()))
            feats.append(np.log1p(gap.mean()))
            hist, _ = np.histogram(dist, bins=_DIST_EDGES)
            feats.extend((hist / dist.size).tolist())
        else:
            feats.extend([0.0] * (3 + len(_DIST_EDGES) - 1))

        # per-engine-class issue gaps (DMA queues, MXU pipe, vector memory)
        for name in _CLASSES:
            ids = self._class_ids[name]
            feats.append(ids.size / n)
            if ids.size >= 2:
                p_sorted = np.sort(pos_of[ids])
                cg = prefix[p_sorted[1:]] - prefix[p_sorted[:-1]]
                feats.append(np.log1p(cg.mean()))
                feats.append(min(float(cg.min()) / 16.0, 4.0))
                feats.append(float((cg <= 2.0).mean()))
            else:
                feats.extend([0.0, 0.0, 0.0])

        out = np.asarray(feats, dtype=np.float32)
        assert out.shape[0] == FEATURE_DIM, out.shape
        return out

    def features_many(self, orders: Sequence[Sequence[int]]) -> np.ndarray:
        if len(orders) == 0:
            return np.empty((0, FEATURE_DIM), np.float32)
        return np.stack([self.features(o) for o in orders])


def _canonical_records(records: tuple) -> tuple:
    """Timing records with set-valued fields sorted — a process-independent
    representation (frozenset iteration order is hash-randomized)."""
    return tuple(
        tuple(tuple(sorted(x)) if isinstance(x, frozenset) else x
              for x in rec)
        for rec in records)


def _split_of(records: tuple, permutation: np.ndarray,
              eval_fraction: float) -> int:
    """Deterministic train(0)/eval(1) assignment for one schedule."""
    h = hashlib.sha256(repr(_canonical_records(records)).encode()
                       + b"|" + permutation.tobytes()).digest()
    frac = int.from_bytes(h[:8], "big") / 2.0 ** 64
    return 1 if frac < eval_fraction else 0


@dataclasses.dataclass
class CostDataset:
    """Feature matrix + log-cycle targets exported from a measurement memo.

    ``group`` carries each row's program fingerprint (the ranking loss
    only compares schedules of the same program); ``split`` is 0 for
    train rows, 1 for held-out eval rows.
    """

    X: np.ndarray                        # (N, FEATURE_DIM) float32
    y: np.ndarray                        # (N,) float32, log(cycles)
    group: np.ndarray                    # (N,) int64 fingerprint ids
    split: np.ndarray                    # (N,) uint8: 0 train / 1 eval
    feature_version: int = FEATURE_VERSION

    def __len__(self) -> int:
        return int(self.X.shape[0])

    @property
    def train(self) -> "CostDataset":
        return self._subset(self.split == 0)

    @property
    def eval(self) -> "CostDataset":
        return self._subset(self.split == 1)

    def _subset(self, mask: np.ndarray) -> "CostDataset":
        return CostDataset(self.X[mask], self.y[mask], self.group[mask],
                           self.split[mask], self.feature_version)

    @classmethod
    def from_memo(cls, memo, programs: Dict[str, Sequence[Instruction]],
                  stall_db: Optional[Dict[str, int]] = None,
                  eval_fraction: float = 0.25,
                  featurizers: Optional[Dict[str, ProgramFeaturizer]] = None
                  ) -> "CostDataset":
        """Export every resident memo entry belonging to one of
        ``programs`` (name -> baseline instruction list) into a dataset.

        Each program is fingerprinted through the memo's interner to join
        against :meth:`SharedMeasureMemo.export_entries`; entries for
        programs not supplied here (other kernels, other autotune configs)
        are skipped, as are evicted entries (absent from the export by
        construction) and non-permutation keys.
        """
        ftz = dict(featurizers or {})
        fp_to_name: Dict[int, str] = {}
        for name, program in programs.items():
            fp_to_name[memo.fingerprint(program)] = name
            if name not in ftz:
                ftz[name] = ProgramFeaturizer(program, stall_db=stall_db)
        rows, ys, groups, splits = [], [], [], []
        for entry in memo.export_entries():
            name = fp_to_name.get(entry.fingerprint)
            if name is None or entry.permutation is None:
                continue
            f = ftz[name]
            if entry.permutation.shape[0] != f.n or entry.cycles <= 0:
                continue
            rows.append(f.features(entry.permutation))
            ys.append(np.log(entry.cycles))
            groups.append(entry.fingerprint)
            splits.append(_split_of(entry.records, entry.permutation,
                                    eval_fraction))
        if not rows:
            return cls(np.empty((0, FEATURE_DIM), np.float32),
                       np.empty(0, np.float32), np.empty(0, np.int64),
                       np.empty(0, np.uint8))
        return cls(np.stack(rows),
                   np.asarray(ys, np.float32),
                   np.asarray(groups, np.int64),
                   np.asarray(splits, np.uint8))

    @classmethod
    def concat(cls, datasets: Sequence["CostDataset"]) -> "CostDataset":
        """Concatenate datasets built from *different* memos: fingerprint
        ids are process-local per memo, so each dataset's groups are
        offset into a disjoint range before stacking."""
        datasets = [d for d in datasets if len(d)]
        if not datasets:
            return cls(np.empty((0, FEATURE_DIM), np.float32),
                       np.empty(0, np.float32), np.empty(0, np.int64),
                       np.empty(0, np.uint8))
        versions = {d.feature_version for d in datasets}
        if len(versions) > 1:
            raise CostModelVersionError(
                f"cannot concat datasets of feature versions {versions}")
        groups, offset = [], 0
        for d in datasets:
            groups.append(d.group + offset)
            offset += int(d.group.max()) + 1
        return cls(np.concatenate([d.X for d in datasets]),
                   np.concatenate([d.y for d in datasets]),
                   np.concatenate(groups),
                   np.concatenate([d.split for d in datasets]),
                   datasets[0].feature_version)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> int:
        """Write the dataset as a versioned ``.npz``; returns row count."""
        np.savez(path, format=DATASET_FORMAT, version=DATASET_VERSION,
                 feature_version=self.feature_version,
                 X=self.X, y=self.y, group=self.group, split=self.split)
        return len(self)

    @classmethod
    def load(cls, path: str) -> "CostDataset":
        """Load a dataset ``.npz``; raises :class:`CostModelVersionError`
        on corrupt or unknown-version files."""
        try:
            with np.load(path, allow_pickle=False) as z:
                if "format" not in z.files \
                        or str(z["format"]) != DATASET_FORMAT:
                    raise CostModelVersionError(
                        f"{path} is not a {DATASET_FORMAT} file")
                version = int(z["version"])
                if version not in _KNOWN_DATASET_VERSIONS:
                    raise CostModelVersionError(
                        f"dataset {path} has version {version!r}; this "
                        f"build reads {_KNOWN_DATASET_VERSIONS}")
                return cls(z["X"], z["y"], z["group"], z["split"],
                           int(z["feature_version"]))
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            raise CostModelVersionError(
                f"corrupt cost dataset {path}: {e}") from e
