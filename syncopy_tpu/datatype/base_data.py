# -*- coding: utf-8 -*-
#
# BaseData: abstract root of the data-class hierarchy.
#
# Parity target: reference syncopy/datatype/base_data.py:53-1519. Redesigned
# storage model: the payload lives either as an in-memory numpy array (the
# default — host RAM is the staging buffer for HBM transfers) or as an HDF5
# dataset on disk (for larger-than-memory data and for .spy container
# round-trips). All dataset setters of the reference are supported
# (ndarray / list-of-trials / h5py.Dataset / filename / generator;
# reference base_data.py:263-803).

import getpass
import os
import socket
from abc import ABC
from datetime import datetime

import numpy as np

from ..shared.errors import SPYError, SPYTypeError, SPYValueError
from ..shared.filetypes import FILE_EXT, extension_by_class
from ..shared.tools import SerializableDict, StructDict, is_h5_dataset
from .util import TrialIndexer, gen_session_filename

__all__ = ["BaseData", "FauxTrial"]


class BaseData(ABC):
    """
    Abstract base class of all syncopy_tpu data containers.

    Subclasses define ``_defaultDimord`` plus the dimensional properties
    (channel labels, samplerate, freq, ...). The payload is exposed through
    ``.data`` (numpy ndarray or h5py.Dataset) with trials delimited by
    ``.trialdefinition`` along the stacking dimension.
    """

    #: properties that are serialized into the .info sidecar file on save
    _infoFileProperties = ("dimord", "_version", "_log", "cfg", "info")
    #: properties stored as HDF5 attributes on save
    _hdfFileAttributeProperties = ("dimord", "_version", "_log")
    #: datasets beyond the main one (registered via _register_dataset)
    _hdfFileDatasetProperties = ("data",)

    _defaultDimord = None
    _stackingDimLabel = None
    _version = "0.1"

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #

    #: monotonically increasing payload-version tokens (engine device-cache
    #: invalidation): bumped whenever the payload or trial layout changes
    _token_counter = 0

    def _bump_cache_token(self):
        BaseData._token_counter += 1
        self._cache_token = BaseData._token_counter

    def __init__(self, filename=None, dimord=None):
        self._bump_cache_token()
        self._cfg = StructDict()
        self._info = SerializableDict()
        self._data = None
        # HBM-resident payload handle (engine/resident.py): set by the
        # compute engine when results stay on device with deferred readback
        self._device_resident = None
        self._extra_datasets = {}
        self._hdfFile = None
        self._filename = filename
        self._mode = "r+"
        self._trialdefinition = None
        self._selection = None
        self._is_temp_file = False
        self._log_header = "created {} by {}@{}".format(
            datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
            getpass.getuser(),
            socket.gethostname(),
        )
        self._log = ""
        self.log = "created {} object".format(self.__class__.__name__)
        self._set_dimord(dimord)

    def _set_dimord(self, dimord):
        if dimord is None:
            self._dimord = list(self._defaultDimord) if self._defaultDimord else None
        else:
            dimord = list(dimord)
            if self._defaultDimord is not None and sorted(dimord) != sorted(self._defaultDimord):
                # allow permutations for classes that support custom dimords
                if not getattr(self, "_customizableDimord", False):
                    raise SPYValueError(
                        legal=str(self._defaultDimord),
                        varname="dimord",
                        actual=str(dimord),
                    )
            self._dimord = dimord

    # ------------------------------------------------------------------ #
    # core properties
    # ------------------------------------------------------------------ #

    @property
    def dimord(self):
        """list(str): ordered dimension labels of the payload"""
        return list(self._dimord) if self._dimord is not None else None

    @property
    def _stackingDim(self):
        return self.dimord.index(self._stackingDimLabel)

    @property
    def data(self):
        """Payload: numpy ndarray or h5py.Dataset"""
        return self._data

    @data.setter
    def data(self, inData):
        self._set_dataset_property(inData, "data")

    @property
    def filename(self):
        if self._filename is None:
            self._filename = gen_session_filename(
                extension_by_class(self.__class__.__name__) or ".dat"
            )
        return self._filename

    @filename.setter
    def filename(self, fname):
        if not isinstance(fname, str):
            raise SPYTypeError(fname, varname="filename", expected="str")
        self._filename = os.path.abspath(os.path.expanduser(fname))

    @property
    def container(self):
        from ..shared.parsers import filename_parser

        if self._filename is not None and os.path.exists(str(self._filename)):
            return filename_parser(self._filename).get("container")
        return None

    @property
    def tag(self):
        from ..shared.parsers import filename_parser

        if self._filename is not None and os.path.exists(str(self._filename)):
            return filename_parser(self._filename).get("tag")
        return None

    @property
    def mode(self):
        """str: 'r' (read-only) or 'r+' (read/write)"""
        return self._mode

    @mode.setter
    def mode(self, md):
        if md not in ("r", "r+", "w"):
            raise SPYValueError(legal="'r', 'r+' or 'w'", varname="mode", actual=str(md))
        if md == self._mode:
            return
        if is_h5_dataset(self._data):
            import h5py

            fname = self._data.file.filename
            self._close_hdf()
            if md == "w":
                # truncate
                f = h5py.File(fname, "w")
                self._hdfFile = f
                self._data = None
            else:
                f = h5py.File(fname, md)
                self._hdfFile = f
                self._data = f["data"]
                for name in list(self._extra_datasets):
                    if name in f:
                        self._extra_datasets[name] = f[name]
        self._mode = "r+" if md == "w" else md

    @property
    def is_writable(self):
        return self._mode != "r"

    @property
    def tdim(self):
        return None

    # ------------------------------------------------------------------ #
    # dataset setters (reference base_data.py:263-803)
    # ------------------------------------------------------------------ #

    def _set_dataset_property(self, inData, propertyName, ndim=None):
        self._bump_cache_token()
        if propertyName == "data" and self._device_resident is not None:
            # payload is being replaced: the device-resident copy (and any
            # pending deferred readback) is obsolete — drop it
            self._device_resident.records = None
            self._device_resident = None
        if inData is None:
            self._close_hdf()
            if propertyName == "data":
                self._data = None
            else:
                self._extra_datasets.pop(propertyName, None)
            return
        if isinstance(inData, np.ndarray):
            self._set_dataset_property_with_ndarray(inData, propertyName, ndim)
        elif is_h5_dataset(inData):
            self._set_dataset_property_with_dataset(inData, propertyName, ndim)
        elif isinstance(inData, str):
            self._set_dataset_property_with_str(inData, propertyName, ndim)
        elif isinstance(inData, list):
            self._set_dataset_property_with_list(inData, propertyName, ndim)
        elif hasattr(inData, "__next__"):
            self._set_dataset_property_with_generator(inData, propertyName)
        else:
            raise SPYTypeError(
                inData,
                varname=propertyName,
                expected="numpy.ndarray, h5py.Dataset, filename str, list of arrays or generator",
            )

    def _check_dataset_property_complies(self, inData, propertyName, ndim=None):
        if ndim is not None and inData.ndim != ndim:
            raise SPYValueError(
                legal="{}-dimensional data".format(ndim),
                varname=propertyName,
                actual="{}-dimensional".format(inData.ndim),
            )

    def _set_dataset_property_with_ndarray(self, inData, propertyName, ndim=None):
        if ndim is None and self._defaultDimord is not None and propertyName == "data":
            ndim = len(self._defaultDimord)
        self._check_dataset_property_complies(inData, propertyName, ndim)
        if propertyName == "data":
            if is_h5_dataset(self._data):
                # keep disk backing: overwrite in place if shapes match
                if self._data.shape == inData.shape and self._data.dtype == inData.dtype and self.is_writable:
                    self._data[()] = inData
                    return
                self._close_hdf()
            self._data = inData
        else:
            self._extra_datasets[propertyName] = inData

    def _set_dataset_property_with_dataset(self, inData, propertyName, ndim=None):
        if not inData.id.valid:
            raise SPYValueError(legal="open HDF5 dataset", varname=propertyName, actual="closed dataset")
        if ndim is None and propertyName == "data":
            ref_dimord = self._dimord or self._defaultDimord
            if ref_dimord is not None:
                # discrete classes store [nEvents x nCols] 2-D payloads
                # regardless of dimord length
                ndim = 2 if "sample" in ref_dimord else len(ref_dimord)
        self._check_dataset_property_complies(inData, propertyName, ndim)
        if propertyName == "data":
            self._data = inData
            self._hdfFile = inData.file
            self._filename = inData.file.filename
            self._mode = inData.file.mode
        else:
            self._extra_datasets[propertyName] = inData

    def _set_dataset_property_with_str(self, inData, propertyName, ndim=None):
        fpath = os.path.abspath(os.path.expanduser(inData))
        if not os.path.isfile(fpath):
            raise SPYValueError(legal="existing HDF5 file", varname=propertyName, actual=inData)
        import h5py

        md = self._mode if self._mode in ("r", "r+") else "r+"
        try:
            f = h5py.File(fpath, md)
        except OSError:
            f = h5py.File(fpath, "r")
            md = "r"
        if propertyName not in f:
            available = list(f.keys())
            f.close()
            raise SPYValueError(
                legal="HDF5 file containing dataset '{}'".format(propertyName),
                varname=propertyName,
                actual="datasets {}".format(available),
            )
        dset = f[propertyName]
        self._check_dataset_property_complies(dset, propertyName, ndim)
        if propertyName == "data":
            self._hdfFile = f
            self._data = dset
            self._filename = fpath
            self._mode = md
            # load known extra datasets
            for name in f.keys():
                if name not in ("data",) and name in self._hdfFileDatasetProperties:
                    self._extra_datasets[name] = f[name]
        else:
            self._extra_datasets[propertyName] = dset

    def _set_dataset_property_with_list(self, inData, propertyName, ndim=None):
        if (propertyName == "data" and inData
                and all(isinstance(o, BaseData) for o in inData)):
            # list of syncopy objects: trial-concatenate them (reference
            # constructor semantics, tests/test_continuousdata.py:268-305)
            return self._init_from_object_list(inData)
        # list of per-trial arrays -> stack along stacking dim + trialdefinition
        arrs = [np.asarray(a) for a in inData]
        if not arrs:
            raise SPYValueError(legal="non-empty list", varname=propertyName)
        # real/complex must not mix: np.concatenate would silently upcast
        # (reference list-routine check, tests/test_basedata.py:155-158)
        kinds = {np.issubdtype(a.dtype, np.complexfloating) for a in arrs}
        if len(kinds) > 1:
            raise SPYValueError(
                legal="all trials of the same numeric type (real/complex)",
                varname=propertyName,
                actual=str(sorted({str(a.dtype) for a in arrs})),
            )
        base_shape = list(arrs[0].shape)
        sdim = self._stackingDim
        for a in arrs:
            shp = list(a.shape)
            if len(shp) != len(base_shape):
                raise SPYTypeError(a, varname=propertyName, expected="arrays of equal ndim")
            shp_other = [s for k, s in enumerate(shp) if k != sdim]
            base_other = [s for k, s in enumerate(base_shape) if k != sdim]
            if shp_other != base_other:
                raise SPYValueError(
                    legal="equal shapes along non-stacking dims",
                    varname=propertyName,
                    actual=str([tuple(a.shape) for a in arrs]),
                )
        stacked = np.concatenate(arrs, axis=sdim)
        self._set_dataset_property_with_ndarray(stacked, propertyName, ndim)
        lens = [a.shape[sdim] for a in arrs]
        bounds = np.cumsum([0] + lens)
        trl = np.zeros((len(arrs), 3))
        trl[:, 0] = bounds[:-1]
        trl[:, 1] = bounds[1:]
        self.trialdefinition = trl

    def _set_dataset_property_with_generator(self, gen, propertyName):
        arrs = list(gen)
        self._set_dataset_property_with_list(arrs, propertyName)

    def _init_from_object_list(self, objs):
        """Trial-concatenate a list of same-class objects into this one
        (reference AnalogData([obj1, obj2]) constructor semantics)."""
        first = objs[0]
        for o in objs:
            if o.__class__ is not first.__class__:
                raise SPYValueError(
                    legal="objects of the same class", varname="data",
                    actual="{} vs {}".format(first.__class__.__name__,
                                             o.__class__.__name__),
                )
            if o.dimord != first.dimord:
                raise SPYValueError(
                    legal="matching dimords (same stacking dimension)",
                    varname="data",
                    actual="different stacking: {} vs {}".format(first.dimord, o.dimord),
                )
            if getattr(o, "samplerate", None) is None:
                raise SPYValueError(
                    legal="all objects with a samplerate set", varname="data",
                    actual="missing attribute `samplerate`",
                )
            if o.samplerate != first.samplerate:
                raise SPYValueError(
                    legal="equal samplerates", varname="data",
                    actual="different attribute `samplerate`",
                )
            if "channel" in first.dimord and first.channel is not None:
                oc, fc = np.asarray(o.channel), np.asarray(first.channel)
                # count mismatches surface as shape errors below
                if oc.size == fc.size and list(oc) != list(fc):
                    raise SPYValueError(
                        legal="equal channel labels", varname="data",
                        actual="different attribute `channel`",
                    )
        sdim = first._stackingDim
        ref_other = None
        trials = []
        trl_rows = []
        offset = 0
        for o in objs:
            for k, t in enumerate(o.trials):
                arr = np.asarray(t)
                other = [s for i, s in enumerate(arr.shape) if i != sdim]
                if ref_other is None:
                    ref_other = other
                elif other != ref_other:
                    raise SPYValueError(
                        legal="equal shapes along non-stacking dims",
                        varname="data", actual="mismatching shapes",
                    )
                trials.append(arr)
                n = arr.shape[sdim]
                row = [offset, offset + n, o.trialdefinition[k, 2]]
                row.extend(o.trialdefinition[k, 3:])
                trl_rows.append(row)
                offset += n
        self._set_dataset_property_with_ndarray(
            np.concatenate(trials, axis=sdim), "data"
        )
        ncols = max(len(r) for r in trl_rows)
        trl = np.zeros((len(trl_rows), ncols))
        for i, r in enumerate(trl_rows):
            trl[i, : len(r)] = r
        self._trialdefinition = trl
        self.samplerate = first.samplerate
        if "channel" in first.dimord and first.channel is not None:
            try:
                self.channel = np.asarray(first.channel)
            except Exception:
                pass

    def _register_dataset(self, propertyName, inData=None):
        """
        Attach an additional named dataset (e.g. ``avg``/``var``/``cov`` on
        TimeLockData, ``jack_var`` on connectivity outputs); reference
        base_data.py:178.
        """
        if not propertyName.isidentifier():
            raise SPYValueError(legal="valid identifier", varname="propertyName", actual=propertyName)
        if inData is not None:
            self._extra_datasets[propertyName] = np.asarray(inData) if not is_h5_dataset(inData) else inData
        elif self._extra_datasets.get(propertyName) is not None:
            # attaching None DETACHES an existing dataset (reference
            # test_attach_dataset.py:139); declaring a fresh slot stays a
            # no-op placeholder
            self._extra_datasets[propertyName] = None
        else:
            self._extra_datasets.setdefault(propertyName, None)

    def _get_extra_dataset(self, name):
        val = self._extra_datasets.get(name)
        return val

    @property
    def _registered_datasets(self):
        return {k: v for k, v in self._extra_datasets.items() if k != "data"}

    def _close_hdf(self):
        if self._hdfFile is not None:
            try:
                self._hdfFile.close()
            except Exception:
                pass
            self._hdfFile = None
            self._data = None if is_h5_dataset(self._data) else self._data
            self._extra_datasets = {
                k: (None if is_h5_dataset(v) else v) for k, v in self._extra_datasets.items()
            }

    def to_hdf(self, filename=None):
        """Move the (in-memory) payload onto disk, returning the filename."""
        if is_h5_dataset(self._data):
            return self._data.file.filename
        import h5py

        fname = filename or self.filename
        with h5py.File(fname, "w") as f:
            f.create_dataset("data", data=self._data)
            for name, arr in self._extra_datasets.items():
                if arr is not None:
                    f.create_dataset(name, data=np.asarray(arr))
        f = h5py.File(fname, "r+")
        self._hdfFile = f
        self._data = f["data"]
        for name in list(self._extra_datasets):
            if name in f:
                self._extra_datasets[name] = f[name]
        self._is_temp_file = True
        return fname

    # ------------------------------------------------------------------ #
    # trial handling
    # ------------------------------------------------------------------ #

    @property
    def trialdefinition(self):
        """nTrials x >=3 array: [start, stop, offset(, trialinfo...)]"""
        return np.array(self._trialdefinition) if self._trialdefinition is not None else None

    @trialdefinition.setter
    def trialdefinition(self, trl):
        from .methods.definetrial import definetrial

        definetrial(self, trialdefinition=trl)

    @property
    def sampleinfo(self):
        """nTrials x 2 [start, stop] sample indices"""
        trl = self._trialdefinition
        if trl is None:
            return None
        # hot path (engine shape planning touches this per trial): cache the
        # int view keyed by array identity — trialdefinition is only ever
        # REASSIGNED (never mutated in place) throughout the package
        cached = getattr(self, "_sampleinfo_cache", None)
        if cached is not None and cached[0] is trl:
            return cached[1]
        si = trl[:, :2].astype(np.int64)
        self._sampleinfo_cache = (trl, si)
        return si

    @sampleinfo.setter
    def sampleinfo(self, si):
        raise SPYError("Cannot set sampleinfo directly, use `trialdefinition`")

    @property
    def trialinfo(self):
        """nTrials x M additional per-trial info columns"""
        if self._trialdefinition is None:
            return None
        return self._trialdefinition[:, 3:]

    @trialinfo.setter
    def trialinfo(self, ti):
        if self._trialdefinition is None:
            raise SPYError("Define trials first before setting trialinfo")
        ti = np.atleast_2d(np.asarray(ti))
        if ti.shape[0] != self._trialdefinition.shape[0]:
            raise SPYValueError(
                legal="{} rows".format(self._trialdefinition.shape[0]),
                varname="trialinfo",
                actual=str(ti.shape),
            )
        self._trialdefinition = np.hstack([self._trialdefinition[:, :3], ti])

    @property
    def _t0(self):
        if self._trialdefinition is None:
            return None
        return self._trialdefinition[:, 2].astype(np.int64)

    @property
    def trial_ids(self):
        """Index list of trials (reference base_data.py:1005-1008)."""
        if self._trialdefinition is not None:
            return list(range(self._trialdefinition.shape[0]))

    def clear(self):
        """Flush any HDF5-backed datasets to release cached chunks
        (reference base_data.py:1077-1086)."""
        for propName in getattr(self, "_hdfFileDatasetProperties", ("data",)):
            dset = getattr(self, "_" + propName, None)
            if dset is not None and hasattr(dset, "flush"):
                dset.flush()

    def singlepanelplot(self, **kwargs):
        """Plot this object in a single panel (reference plotting dispatch)."""
        from ..plotting.spy_plotting import singlepanelplot

        return singlepanelplot(self, **kwargs)

    def multipanelplot(self, **kwargs):
        """Plot this object in per-channel panels (reference plotting dispatch)."""
        from ..plotting.spy_plotting import multipanelplot

        return multipanelplot(self, **kwargs)

    @property
    def trialintervals(self):
        """nTrials x 2 array of trial [start, end] in trigger-relative
        seconds (reference base_data.py trialintervals property)."""
        if self._trialdefinition is None or getattr(self, "samplerate", None) is None:
            return None
        trl = self._trialdefinition
        fs = self.samplerate
        lens = trl[:, 1] - trl[:, 0]
        starts = trl[:, 2] / fs
        ends = (lens - 1 + trl[:, 2]) / fs
        return np.column_stack([starts, ends])

    @property
    def trials(self):
        """Lazy per-trial array access"""
        if self.sampleinfo is None:
            return None
        ids = list(range(self.sampleinfo.shape[0]))
        return TrialIndexer(self, ids)

    def _get_trial(self, trialno):
        raise NotImplementedError

    @property
    def selection(self):
        """Active in-place selection (Selector or None)"""
        return self._selection

    @selection.setter
    def selection(self, select):
        from .selector import Selector

        if select is None:
            self._selection = None
        elif isinstance(select, Selector):
            self._selection = select
        else:
            self._selection = Selector(self, select)

    # ------------------------------------------------------------------ #
    # provenance: log / cfg / info
    # ------------------------------------------------------------------ #

    @property
    def log(self):
        """Human-readable history (appending via ``obj.log = 'msg'``)"""
        return self._log_header + self._log

    @log.setter
    def log(self, msg):
        if not isinstance(msg, str):
            raise SPYTypeError(msg, varname="log", expected="str")
        prefix = "\n\n|=== {user}@{host}: {time} ===|\n\n\t{msg}"
        self._log += prefix.format(
            user=getpass.getuser(),
            host=socket.gethostname(),
            time=datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
            msg=msg,
        )

    @property
    def cfg(self):
        """Replayable record of the frontend call(s) that produced this object"""
        return self._cfg

    @cfg.setter
    def cfg(self, dct):
        if not isinstance(dct, dict):
            raise SPYTypeError(dct, varname="cfg", expected="dict")
        self._cfg = StructDict(dct)

    @property
    def info(self):
        """Free-form user metadata (JSON-serializable)"""
        return self._info

    @info.setter
    def info(self, dct):
        if not isinstance(dct, dict):
            raise SPYTypeError(dct, varname="info", expected="dict")
        self._info = SerializableDict(dct)

    # ------------------------------------------------------------------ #
    # comparison / copy / persistence
    # ------------------------------------------------------------------ #

    def __eq__(self, other):
        if other is self:
            return True
        if not isinstance(other, BaseData):
            return False
        if self.__class__ != other.__class__:
            return False
        if self.dimord != other.dimord:
            return False
        self_empty = self.data is None
        other_empty = other.data is None
        if self_empty != other_empty:
            return False
        if not self_empty:
            if self.data.shape != other.data.shape:
                return False
            td_s, td_o = self.trialdefinition, other.trialdefinition
            if (td_s is None) != (td_o is None):
                return False
            if td_s is not None and not np.array_equal(td_s, td_o):
                return False
            for ts, to in zip(self.trials, other.trials):
                # no float64 cast: it would silently DROP imaginary parts,
                # making complex payloads differing only in phase compare
                # equal; allclose handles complex/float/int natively
                if not np.allclose(np.asarray(ts), np.asarray(to), equal_nan=True):
                    return False
        # registered extra datasets are part of the object's identity
        # (reference tests/test_attach_dataset.py:75-137: objects differing
        # only in an attached dataset — presence or values — compare unequal)
        mine = {k: v for k, v in self._registered_datasets.items() if v is not None}
        theirs = {k: v for k, v in other._registered_datasets.items() if v is not None}
        if set(mine) != set(theirs):
            return False
        for k, v in mine.items():
            a, b = np.asarray(v), np.asarray(theirs[k])
            if a.shape != b.shape or not np.allclose(a, b, equal_nan=True):
                return False
        return True

    def __ne__(self, other):
        return not self.__eq__(other)

    def copy(self):
        """Deep copy (reference datatype/methods/copy.py:20)."""
        from .methods.copy import copy as _copy

        return _copy(self)

    def save(self, container=None, tag=None, filename=None, overwrite=False):
        """Persist to a .spy container (reference io/save_spy_container.py:25)."""
        from ..io.save_spy_container import save

        return save(self, container=container, tag=tag, filename=filename, overwrite=overwrite)

    def selectdata(self, trials=None, channel=None, latency=None, frequency=None,
                   taper=None, unit=None, eventid=None, inplace=False, clear=False, **kwargs):
        """Create a new object from a selection (reference methods/selectdata.py:28)."""
        from .methods.selectdata import selectdata

        return selectdata(
            self, trials=trials, channel=channel, latency=latency, frequency=frequency,
            taper=taper, unit=unit, eventid=eventid, inplace=inplace, clear=clear, **kwargs
        )

    def show(self, squeeze=True, **kwargs):
        """Load (selected) data into a numpy array (reference methods/show.py:15)."""
        from .methods.show import show

        return show(self, squeeze=squeeze, **kwargs)

    def definetrial(self, trl=None, **kwargs):
        from .methods.definetrial import definetrial

        definetrial(self, trialdefinition=trl, **kwargs)

    # ------------------------------------------------------------------ #
    # arithmetic dunders (reference base_data.py:1263-1288)
    # ------------------------------------------------------------------ #

    def __add__(self, other):
        from .methods.arithmetic import _process_operator

        return _process_operator(self, other, "+")

    def __radd__(self, other):
        from .methods.arithmetic import _process_operator

        return _process_operator(self, other, "+")

    def __sub__(self, other):
        from .methods.arithmetic import _process_operator

        return _process_operator(self, other, "-")

    def __rsub__(self, other):
        from .methods.arithmetic import _process_operator

        return _process_operator(self, other, "-", reverse=True)

    def __mul__(self, other):
        from .methods.arithmetic import _process_operator

        return _process_operator(self, other, "*")

    def __rmul__(self, other):
        from .methods.arithmetic import _process_operator

        return _process_operator(self, other, "*")

    def __truediv__(self, other):
        from .methods.arithmetic import _process_operator

        return _process_operator(self, other, "/")

    def __rtruediv__(self, other):
        from .methods.arithmetic import _process_operator

        return _process_operator(self, other, "/", reverse=True)

    def __pow__(self, other):
        from .methods.arithmetic import _process_operator

        return _process_operator(self, other, "**")

    # ------------------------------------------------------------------ #
    # repr / cleanup
    # ------------------------------------------------------------------ #

    def __repr__(self):
        return self.__str__()

    def __str__(self):
        lines = ["syncopy_tpu {}".format(self.__class__.__name__)]
        if self.data is None:
            lines.append("empty")
        else:
            lines.append("data shape: {} [{}]".format(self.data.shape, " x ".join(self.dimord)))
            if self.trialdefinition is not None:
                lines.append("{} trials".format(len(self.trials)))
        attrs = []
        for name in ("samplerate",):
            if hasattr(self, name) and getattr(self, name) is not None:
                attrs.append("{}: {}".format(name, getattr(self, name)))
        lines.extend(attrs)
        storage = "in-memory" if isinstance(self._data, np.ndarray) else (
            "hdf5: {}".format(self._filename) if self._data is not None else "no data"
        )
        lines.append("storage: {}".format(storage))
        return "\n".join(lines)

    def __del__(self):
        try:
            fname = self._filename
            backed = self._hdfFile is not None
            self._close_hdf()
            if backed and self._is_temp_file and fname and os.path.exists(fname):
                os.unlink(fname)
                info_file = fname + FILE_EXT["info"]
                if os.path.exists(info_file):
                    os.unlink(info_file)
        except Exception:
            pass


class FauxTrial:
    """
    Shape/dtype stand-in for a single trial, used for zero-I/O dry-runs
    (reference base_data.py:1458-1519). With `jax.eval_shape` doing the
    heavy lifting in the engine, this remains for API familiarity and for
    host-side planning.
    """

    def __init__(self, shape, idx, dtype, dimord):
        self.shape = tuple(shape)
        self.idx = tuple(idx)
        self.dtype = dtype
        self.dimord = list(dimord)

    def __str__(self):
        return "{}-element FauxTrial of shape {}".format(len(self.shape), self.shape)

    @property
    def T(self):
        return FauxTrial(self.shape[::-1], self.idx[::-1], self.dtype, self.dimord[::-1])

    def squeeze(self):
        shp = [s for s in self.shape if s != 1]
        idx = [i for i, s in zip(self.idx, self.shape) if s != 1]
        dimord = [d for d, s in zip(self.dimord, self.shape) if s != 1]
        return FauxTrial(shp, idx, self.dtype, dimord)
