"""First-party IFCB (Imaging FlowCytobot) bin reader (the port's copy of
ifcb_classifier_tpu/data/ifcb.py).

Replaces the reference's external `pyifcb` dependency (used at
neuston_data.py:14-16, neuston_net.py:211-247,
neuston_callbacks.py:176-182) with a clean host-side ingestion module:

  * Pid           — the IFCB permanent-identifier grammar (old + new styles),
                    `.year`/`.yearday`/`.target`/`.with_target(n)`/`.namespace`
  * parse_adc     — the .adc CSV trigger table for schema v1 (old) and v2 (new)
  * Bin           — one .adc/.roi/.hdr triplet; `.images` = {target: 2-D uint8}
  * infilled_images — schema-v1 multi-ROI-per-trigger stitching (the reference's
                    `ifcb.data.stitching.InfilledImages`, neuston_data.py:446-449)
  * DataDirectory — recursive bin discovery with whitelist/blacklist filters

Everything here is host-side numpy; ROI pixel extraction is zero-copy byte
slicing out of a single bulk .roi read (one heap buffer per bin; views pin
it for their lifetime), feeding the device prefetch pipeline
(data/pipeline.py).

IFCB on-disk format (public instrument format):
  .adc  CSV, no header, one row per trigger event/target. Column layout depends
        on schema generation. Targets are numbered by 1-based row position.
  .roi  concatenated raw 8-bit grayscale pixels; each target's pixels start at
        `startByte` and span `width*height` bytes, row-major (height, width).
  .hdr  text key:value instrument metadata.
"""

from __future__ import annotations

import os
import re
from functools import cached_property

import numpy as np

__all__ = [
    "Pid", "Bin", "DataDirectory", "parse_adc", "infilled_images",
    "SCHEMA_VERSION_1", "SCHEMA_VERSION_2",
]

SCHEMA_VERSION_1 = 1  # old-style bins: IFCB1_2007_134_123456
SCHEMA_VERSION_2 = 2  # new-style bins: D20150101T000000_IFCB101

# ADC column layouts (positional; files carry no header row).
ADC_COLUMNS_V1 = [
    "trigger", "processingEndTime", "fluorescenceLow", "fluorescenceHigh",
    "scatteringLow", "scatteringHigh", "comparatorPulse", "triggerOpenRate",
    "frameGrabTime", "roiX", "roiY", "roiWidth", "roiHeight", "startByte",
    "comparatorOut", "startPoint", "signalLength", "status",
]
ADC_COLUMNS_V2 = [
    "trigger", "adcTime", "pmtA", "pmtB", "pmtC", "pmtD",
    "peakA", "peakB", "peakC", "peakD", "timeOfFlight",
    "grabTimeStart", "grabTimeEnd", "roiX", "roiY", "roiWidth", "roiHeight",
    "startByte", "comparatorOut", "startPoint", "signalLength", "status",
    "runTime", "inhibitTime",
]

_PID_V2_RE = re.compile(
    r"^(?P<bin>D(?P<date>\d{8})T(?P<time>\d{6})_(?P<instrument>IFCB\d+))"
    r"(?:_(?P<target>\d{5}))?$"
)
_PID_V1_RE = re.compile(
    r"^(?P<bin>(?P<instrument>IFCB\d+)_(?P<year>\d{4})_(?P<yearday>\d{3})_(?P<time>\d{6}))"
    r"(?:_(?P<target>\d{5}))?$"
)


class Pid:
    """IFCB permanent identifier.

    Parses both pid styles, accepts full paths (directories + extension are
    stripped), and carries the mutable `namespace` attribute the reference
    assigns for {INPUT_SUBDIRS} templating (neuston_net.py:234).

    Attributes mirror the `pyifcb` surface consumed by the reference:
      pid        bin id string (no target suffix)      neuston_callbacks.py:178
      target     int target number or None             neuston_callbacks.py:179
      year       int                                   neuston_net.py:245
      yearday    date-ish string used for {BIN_DATE}   neuston_net.py:246
      namespace  relative subdir path string           neuston_net.py:234,247
      with_target(n) -> full target pid string         neuston_data.py:452
    """

    def __init__(self, pid: str):
        name = os.path.basename(str(pid))
        name = os.path.splitext(name)[0]
        m = _PID_V2_RE.match(name)
        if m is not None:
            self.schema_version = SCHEMA_VERSION_2
            d = m.group("date")
            self.year = int(d[:4])
            self.yearday = d  # YYYYMMDD; template D{BIN_DATE} -> 'D20150101'
        else:
            m = _PID_V1_RE.match(name)
            if m is None:
                raise ValueError(f"invalid IFCB pid: {pid!r}")
            self.schema_version = SCHEMA_VERSION_1
            self.year = int(m.group("year"))
            self.yearday = "{}_{}".format(m.group("year"), m.group("yearday"))
        self.pid = m.group("bin")
        self.instrument = m.group("instrument")
        t = m.group("target")
        self.target = int(t) if t is not None else None
        self.namespace = ""

    def with_target(self, target_number: int) -> str:
        """Full pid string for one target, e.g. 'D..._IFCB101_00042'."""
        return "{}_{:05d}".format(self.pid, int(target_number))

    def __str__(self):
        if self.target is not None:
            return self.with_target(self.target)
        return self.pid

    def __repr__(self):
        return "<Pid {}>".format(self)

    def __eq__(self, other):
        return isinstance(other, Pid) and str(self) == str(other)

    def __hash__(self):
        return hash(str(self))


def parse_adc(adc_path: str, schema_version: int):
    """Parse an .adc file into a dict of numpy columns.

    Returns {'trigger','roiX','roiY','roiWidth','roiHeight','startByte'}
    as int64 arrays (one entry per row == per target, 1-based target numbers
    are row positions). Tolerates trailing blank lines and float-formatted
    numerics (instruments emit e.g. '1.000000e+00').

    Fast path: pandas' C csv engine reading only the 6 wanted columns
    (deployment runs parse thousands of multi-thousand-row tables; the
    Python-loop fallback covers exotic malformed files).
    """
    columns = ADC_COLUMNS_V1 if schema_version == SCHEMA_VERSION_1 else ADC_COLUMNS_V2
    want = ["trigger", "roiX", "roiY", "roiWidth", "roiHeight", "startByte"]
    idx = {name: columns.index(name) for name in want}
    try:
        import pandas as pd
        usecols = sorted(idx.values())
        df = pd.read_csv(adc_path, header=None, usecols=usecols,
                         skip_blank_lines=True, dtype=np.float64)
        if not np.isfinite(df.to_numpy()).all():
            # an EMPTY field parses as NaN — and an 'inf' literal parses as
            # a FINITE-looking float that isna() misses — and astype(int64)
            # would turn either into INT64_MIN silently: for roiWidth that
            # silently DROPS the ROI (indistinguishable from a normal
            # zero-width trigger row). Raise into the tolerant loop below,
            # which fails loudly on the bad field so RUN's per-bin
            # isolation reports the bin.
            raise ValueError("non-finite field in adc")
        return {name: df[idx[name]].to_numpy().astype(np.int64)
                for name in want}
    except Exception:
        pass  # malformed for the C parser — fall through to tolerant loop
    out = {name: [] for name in want}
    with open(adc_path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            for name in want:
                out[name].append(int(float(parts[idx[name]])))
    return {name: np.asarray(vals, dtype=np.int64) for name, vals in out.items()}


class Bin:
    """One IFCB sample bin: an .adc/.roi/.hdr fileset.

    API parity with the reference's use of pyifcb bins:
      .pid          Pid object (bin id, year/yearday, namespace)
      .schema       SCHEMA_VERSION_1 | SCHEMA_VERSION_2
      .images       {target_number: 2-D uint8 ndarray} for rows with pixels
                    (neuston_data.py:449-453)
      .fileset.basepath  path without extension (neuston_net.py:234)
      len(bin)      number of non-empty targets
    """

    class _Fileset:
        def __init__(self, basepath):
            self.basepath = basepath

    def __init__(self, adc_path: str):
        base, _ = os.path.splitext(adc_path)
        self.adc_path = base + ".adc"
        self.roi_path = base + ".roi"
        self.hdr_path = base + ".hdr"
        self.pid = Pid(base)
        self.schema = self.pid.schema_version
        self.fileset = Bin._Fileset(base)

    @cached_property
    def adc(self):
        return parse_adc(self.adc_path, self.schema)

    @cached_property
    def headers(self) -> dict:
        hdr = {}
        try:
            with open(self.hdr_path, "r", errors="replace") as f:
                for line in f:
                    if ":" in line:
                        k, v = line.split(":", 1)
                        hdr[k.strip()] = v.strip()
        except FileNotFoundError:
            pass
        return hdr

    @cached_property
    def _roi_bytes(self) -> np.ndarray:
        # One bulk read; individual ROIs are zero-copy views into this buffer.
        return np.fromfile(self.roi_path, dtype=np.uint8)

    def target_numbers(self):
        """1-based target numbers of rows that carry pixel data."""
        adc = self.adc
        nz = (adc["roiWidth"] > 0) & (adc["roiHeight"] > 0)
        return [int(i) + 1 for i in np.nonzero(nz)[0]]

    def image(self, target_number: int) -> np.ndarray:
        """2-D uint8 grayscale image of one target (zero-copy view).

        Byte-range validated against the .roi file: a corrupt/truncated bin
        must fail LOUDLY here (and get trapped by RUN's per-bin error
        isolation) — a negative startByte would otherwise wrap via Python
        negative indexing and, when the wrapped slice length happens to be
        h*w, silently classify the wrong bytes (same guard the packed
        predict path applies in infer/runner.py)."""
        adc = self.adc
        row = int(target_number) - 1
        w = int(adc["roiWidth"][row])
        h = int(adc["roiHeight"][row])
        s = int(adc["startByte"][row])
        if w <= 0 or h <= 0:
            raise KeyError(f"target {target_number} has no image")
        if s < 0 or s + w * h > self._roi_bytes.size:
            raise ValueError(
                f"{self.pid}: target {target_number} byte range "
                f"[{s}, {s + w * h}) outside the .roi file "
                f"({self._roi_bytes.size} bytes) — corrupt or truncated bin")
        return self._roi_bytes[s:s + w * h].reshape(h, w)

    @cached_property
    def images(self) -> dict:
        return {t: self.image(t) for t in self.target_numbers()}

    def __len__(self):
        return len(self.target_numbers())

    def __repr__(self):
        return "<Bin {}>".format(self.pid)


def infilled_images(bin: Bin) -> dict:
    """Schema-v1 stitching: composite multi-ROI triggers into one frame.

    Old-format instruments (schema v1) saved each trigger's camera frame as
    several sub-ROIs with (roiX, roiY) frame offsets. The reference wraps such
    bins in `ifcb.data.stitching.InfilledImages` (neuston_data.py:446-449):
    ROIs sharing a trigger are composited onto the bounding-box canvas and the
    uncovered pixels are infilled; the stitched image is keyed by the group's
    first target number. Single-ROI triggers pass through unchanged.

    Our infill is the mean pixel value of the participating ROIs (deterministic;
    pyifcb uses background-matched noise — documented deviation, the infilled
    region carries no signal either way).
    """
    adc = bin.adc
    groups: dict[int, list[int]] = {}
    for row in range(len(adc["trigger"])):
        if adc["roiWidth"][row] <= 0 or adc["roiHeight"][row] <= 0:
            continue
        groups.setdefault(int(adc["trigger"][row]), []).append(row)

    out = {}
    for _, rows in sorted(groups.items()):
        key_target = rows[0] + 1
        if len(rows) == 1:
            out[key_target] = bin.image(key_target)
            continue
        xs = adc["roiX"][rows]
        ys = adc["roiY"][rows]
        ws = adc["roiWidth"][rows]
        hs = adc["roiHeight"][rows]
        x0, y0 = int(xs.min()), int(ys.min())
        x1 = int((xs + ws).max())
        y1 = int((ys + hs).max())
        canvas = np.zeros((y1 - y0, x1 - x0), dtype=np.uint8)
        covered = np.zeros_like(canvas, dtype=bool)
        total, count = 0, 0
        for row in rows:
            img = bin.image(row + 1)
            yy = int(adc["roiY"][row]) - y0
            xx = int(adc["roiX"][row]) - x0
            canvas[yy:yy + img.shape[0], xx:xx + img.shape[1]] = img
            covered[yy:yy + img.shape[0], xx:xx + img.shape[1]] = True
            total += int(img.sum())
            count += img.size
        fill = np.uint8(round(total / max(count, 1)))
        canvas[~covered] = fill
        out[key_target] = canvas
    return out


class DataDirectory:
    """Recursive IFCB bin discovery (the reference's `ifcb.DataDirectory`,
    neuston_net.py:211-228).

    whitelist: only yield bins whose pid or path contains one of the keywords
    blacklist: skip bins whose pid or path contains one of the keywords
    Bins are discovered as .adc files with a co-located .roi; yielded sorted
    by path for determinism.
    """

    def __init__(self, path: str, whitelist=None, blacklist=None,
                 exact=False):
        self.path = path
        self.whitelist = list(whitelist) if whitelist else None
        self.blacklist = list(blacklist) if blacklist else None
        # exact=True: whitelist entries must EQUAL the pid (the .txt
        # bin-list and single-bin paths in infer/runner.py — substring
        # matching would also pick up prefix-sibling bins, e.g. a listed
        # ..._IFCB101 silently classifying ..._IFCB1011 too)
        self.exact = bool(exact)
        self._found = None  # discovery cache (see _discover)

    @classmethod
    def from_basepaths(cls, entries):
        """A DataDirectory over an EXPLICIT list of bin paths (the RUN
        `.txt` bin-list and single-bin SRC forms): each entry (basepath or
        .adc/.roi/.hdr path, absolute or cwd-relative) is resolved by a
        direct stat — no tree walk — and a missing or invalid entry raises
        naming it, instead of silently matching nothing."""
        found, bad = [], []
        for e in entries:
            base, ext = os.path.splitext(e)
            if ext not in (".adc", ".roi", ".hdr"):
                base = e
            try:
                Pid(base)
            except ValueError:
                bad.append(f"{e} (not a valid bin pid)")
                continue
            if not (os.path.isfile(base + ".adc")
                    and os.path.isfile(base + ".roi")):
                bad.append(f"{e} (no .adc/.roi fileset)")
                continue
            found.append(base)
        if bad:
            raise ValueError("bin path(s) could not be resolved: "
                             + "; ".join(bad[:5]))
        dd = cls(path="")
        dd._found = sorted(set(found))
        return dd

    def _match(self, basepath: str) -> bool:
        pid = os.path.basename(basepath)
        if self.exact:
            # exact whitelist membership; the blacklist still applies (it
            # used to be silently ignored) and exact-without-whitelist is
            # a contradiction, not an empty run
            assert self.whitelist is not None, \
                "DataDirectory(exact=True) requires a whitelist"
            if pid not in self.whitelist:
                return False
            return not (self.blacklist is not None
                        and any(k in pid for k in self.blacklist))
        # match against the pid and the path RELATIVE to the search root —
        # NEVER the absolute root itself: a keyword occurring in the SRC
        # path (e.g. RUN /data/ifcb_test_deploy --filter OUT test) would
        # otherwise filter every bin
        rel = os.path.relpath(basepath, self.path)
        hay = rel + "|" + pid
        if self.whitelist is not None:
            if not any(k in hay for k in self.whitelist):
                return False
        if self.blacklist is not None:
            if any(k in hay for k in self.blacklist):
                return False
        return True

    def _discover(self):
        # cached: the instance is a snapshot (filters fixed at construction);
        # len(dd) + iteration must not walk a deployment-scale tree twice.
        # Watch-mode rescans construct a FRESH DataDirectory per pass.
        if self._found is not None:
            return self._found
        found = []
        for pardir, _, files in os.walk(self.path):
            for fname in files:
                if not fname.endswith(".adc"):
                    continue
                base = os.path.join(pardir, os.path.splitext(fname)[0])
                if not os.path.isfile(base + ".roi"):
                    continue
                try:
                    Pid(base)
                except ValueError:
                    continue
                if self._match(base):
                    found.append(base)
        self._found = sorted(found)
        return self._found

    def __iter__(self):
        for base in self._discover():
            yield Bin(base + ".adc")

    def __len__(self):
        return len(self._discover())
