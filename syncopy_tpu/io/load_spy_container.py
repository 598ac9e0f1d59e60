# -*- coding: utf-8 -*-
#
# load: read syncopy_tpu objects from .spy containers.
#
# Parity target: reference syncopy/io/load_spy_container.py:34-345.

import json
import os

import numpy as np

from ..shared.errors import SPYIOError, SPYValueError
from ..shared.filetypes import FILE_EXT, class_by_extension
from ..shared.kwarg_decorators import unwrap_cfg
from .utils import hash_file

__all__ = ["load"]


@unwrap_cfg
def load(filename, tag=None, dataclass=None, checksum=False, mode="r+", out=None):
    """
    Load object(s) from a ``*.spy`` container directory or a single file.

    Parameters
    ----------
    filename : str
        Container directory (``*.spy``) or single data-file path.
    tag : str or None
        Filename filter when the container holds multiple objects.
    dataclass : str or None
        Dataclass filter, e.g. "analog" (file-extension based).
    checksum : bool
        Verify the stored SHA checksum against the on-disk payload.
    mode : {"r+", "r"}
        HDF5 open mode for the returned object's dataset.
    out : Syncopy data object or None
        Pre-allocated object to load into.

    Returns
    -------
    A single matching object, or a dict keyed by filename for multiple
    matches. All datasets stored in the file are restored (including
    attached ones like ``irregular_time``).
    """
    fpath = os.path.abspath(os.path.expanduser(str(filename)))

    if os.path.isdir(fpath) or fpath.endswith(FILE_EXT["dir"]):
        if not os.path.isdir(fpath):
            raise SPYIOError(fpath, exists=False)
        cands = sorted(
            f for f in os.listdir(fpath)
            if any(f.endswith(ext) for ext in FILE_EXT["data"])
        )
        if tag is not None:
            tags = [tag] if isinstance(tag, str) else list(tag)
            cands = [f for f in cands if any(t in f for t in tags)]
        if dataclass is not None:
            dcs = [dataclass] if isinstance(dataclass, str) else list(dataclass)
            exts = []
            for dc in dcs:
                from ..shared.filetypes import extension_by_class

                e = extension_by_class(dc.replace("Data", "") + "Data") or extension_by_class(dc)
                if e:
                    exts.append(e)
            cands = [f for f in cands if any(f.endswith(e) for e in exts)]
        if not cands:
            raise SPYValueError(
                legal="container with matching data files", varname="filename", actual=fpath
            )
        if len(cands) == 1:
            return _load(os.path.join(fpath, cands[0]), checksum, mode)
        return {f: _load(os.path.join(fpath, f), checksum, mode) for f in cands}

    if not any(fpath.endswith(ext) for ext in FILE_EXT["data"]):
        # try appending known extensions
        matches = [fpath + ext for ext in FILE_EXT["data"] if os.path.isfile(fpath + ext)]
        if len(matches) == 1:
            fpath = matches[0]
        else:
            raise SPYIOError(fpath, exists=os.path.exists(fpath))
    return _load(fpath, checksum, mode)


def _load(fpath, checksum, mode):
    if not os.path.isfile(fpath):
        raise SPYIOError(fpath, exists=False)
    ext = "." + fpath.rsplit(".", 1)[-1]
    clsname = class_by_extension(ext)
    if clsname is None:
        raise SPYValueError(legal="known data extension", varname="filename", actual=ext)

    info = {}
    info_file = fpath + FILE_EXT["info"]
    if os.path.isfile(info_file):
        with open(info_file) as fj:
            info = json.load(fj)

    if checksum:
        expected = info.get("file_checksum")
        if expected and hash_file(fpath) != expected:
            raise SPYValueError(
                legal="matching checksum", varname="filename",
                actual="checksum mismatch for {}".format(fpath),
            )

    from .. import datatype

    cls = getattr(datatype, clsname)
    obj = cls.__new__(cls)
    cls.__init__(obj)

    import h5py

    f = h5py.File(fpath, mode)
    if info.get("dimord"):
        obj._dimord = list(info["dimord"])
    elif "dimord" in f.attrs:
        obj._dimord = [str(d) for d in f.attrs["dimord"]]
    obj._hdfFile = f
    obj._data = f["data"]
    obj._filename = fpath
    obj._mode = mode
    obj._is_temp_file = False
    if "trialdefinition" in f:
        obj._trialdefinition = np.array(f["trialdefinition"])
    else:
        nsamp = obj.data.shape[obj._stackingDim] if "sample" not in obj.dimord else None
        if nsamp is not None:
            obj._trialdefinition = np.array([[0, nsamp, 0]], dtype=float)
    # restore ALL attached datasets (class-declared like TimeLockData's
    # avg/var/cov AND dynamically registered ones — jack_var, jack_bias,
    # irregular_time, ...): anything saved beside the payload
    for name in f:
        if name not in ("data", "trialdefinition"):
            obj._extra_datasets[name] = f[name]

    attrs = f.attrs
    if "samplerate" in attrs:
        obj.samplerate = float(attrs["samplerate"])
    for prop in ("channel", "channel_i", "channel_j", "taper", "unit"):
        if prop in attrs and hasattr(obj.__class__, prop):
            try:
                setattr(obj, prop, [str(v) for v in attrs[prop]])
            except Exception:
                setattr(obj, "_" + prop, np.asarray([str(v) for v in attrs[prop]]))
    if "freq" in attrs and hasattr(obj.__class__, "freq"):
        obj.freq = np.asarray(attrs["freq"], dtype=float)

    if info.get("cfg"):
        obj._cfg = type(obj._cfg)(info["cfg"])
    if info.get("info"):
        obj._info = type(obj._info)(info["info"])
    if info.get("_log"):
        obj._log_header = ""
        obj._log = str(info["_log"])
    obj.log = "loaded from {}".format(fpath)
    return obj
