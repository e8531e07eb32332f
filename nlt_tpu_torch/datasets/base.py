"""Dataset base: a threaded host input pipeline feeding static-shape
numpy batches (port of nlt_tpu/datasets/base.py; numpy only, so the
batches are byte-identical to nlt_tpu's).

- a thread pool runs `_load_item` (PIL/numpy IO releases the GIL for the
  heavy parts); these threads never touch the device;
- `cache=True` keeps decoded examples in RAM;
- shuffling reshuffles example order every epoch with a per-epoch seed
  (train only), like shuffle(buffer) but over the full index;
- batches are dicts of stacked float32 numpy arrays (static shapes) plus
  host-side string lists ('id', 'nn_id'); a background prefetch thread
  keeps `prefetch_batches` batches ready so the accelerator never waits.

Collate design: shapes are static per dataset, so every batch's field
arrays are preallocated and the worker threads write each example
directly into its batch slot — there is no per-batch `np.stack` (a
single-threaded, GIL-holding copy of the whole batch). With the packed
disk cache, warm epochs are `readinto` straight from the page cache
into the batch slot: zero decode, zero extra copy.

Disk cache format ("blob", one file per example):

    magic b'NLTB' | u32 version | u32 header_len | header JSON | payload

header: {"fields": [{"name", "dtype", "shape", "enc", "offset",
"nbytes"}...], "strs": {...}} with offsets relative to the payload
start. enc: "raw" (stored dtype == delivered dtype, slot readinto),
"q8" (uint8 -> float32/255, 1/255 quantization — sources are 8-bit
PNGs anyway), "q16" (float16 -> float32; warp's on-disk precision).

Subclass contract:
    _glob() -> list of example ids
    _load_item(id) -> dict of numpy arrays + str fields
"""

import json
import os
import queue
import struct
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..utils import logging as logutil

logger = logutil.Logger(loggee="datasets/base")

ALLOWED_MODES = ("train", "vali", "test")


class Dataset:
    def __init__(self, config, mode, n_workers=16, prefetch_batches=2,
                 cache=None):
        self._validate_mode(mode)
        self.config = config
        self.mode = mode
        self.n_workers = n_workers
        self.prefetch_batches = prefetch_batches
        if cache is None:
            # cache = False | True/'ram' (decoded examples in RAM, like
            # tf.data cache(); reference: nlt/datasets/base.py:100-102)
            # | 'disk' (packed per-example .npz next to the data —
            # quantizes [0,1] images to uint8, ~1/4 the bytes; first
            # epoch writes, later epochs skip PNG decode entirely).
            raw = str(config.get("cache", "False")).strip().lower()
            known = {"true": "ram", "1": "ram", "yes": "ram",
                     "ram": "ram", "disk": "disk",
                     "false": False, "0": False, "no": False,
                     "none": False, "": False}
            if raw not in known:
                raise ValueError(
                    "Unrecognized cache setting %r (use ram/disk/false)"
                    % raw)
            cache = known[raw]
        elif cache is True:
            cache = "ram"
        self.cache_enabled = cache
        self._cache = {}
        self._cache_lock = threading.Lock()
        if cache == "disk":
            root = config.get_list("data_root")[0].rstrip("/")
            # Every knob that changes the example FIELD SET or layout
            # is part of the cache identity — flipping one must not
            # hit blobs written under the other schema: the wire
            # format (uint8 vs f32), the observation count (n_obs
            # stacks the nn fields), and obs_weighting (adds nn_dist;
            # stale blobs without it would silently drop the weights).
            u8 = config.get_bool("device_normalize", False)
            n_obs = config.get_int("n_obs", 1)
            weighting = (config.get("obs_weighting", "none")
                         or "none").lower()
            self._disk_cache_dir = "%s_cache/%s_uv%s_im%s%s%s%s" % (
                root, mode, config.get("uvh"), config.get("imh"),
                "_u8" if u8 else "",
                "_obs%d" % n_obs if n_obs > 1 else "",
                "_w" + weighting if (weighting != "none"
                                     and n_obs > 1) else "")
            os.makedirs(self._disk_cache_dir, exist_ok=True)
        # Batch schema (field -> delivered dtype/shape), discovered from
        # the first loaded example and reused to preallocate batches.
        self._schema = None
        self._schema_lock = threading.Lock()
        # Dedicated pool for per-field IO inside _load_item (separate
        # from the per-item pool to avoid nested-submission deadlock).
        self._io_pool = ThreadPoolExecutor(n_workers)
        self.files = self._glob()
        assert self.files, "No files to process into a dataset"
        self.bs = self._get_batch_size()

    @staticmethod
    def _validate_mode(mode):
        if mode not in ALLOWED_MODES:
            raise ValueError(
                "Invalid mode: %s. Allowed: %s" % (mode, ALLOWED_MODES))

    def _glob(self):
        raise NotImplementedError

    def _get_batch_size(self):
        """'bs' from config unless overridden (reference:
        nlt/datasets/base.py:61-73)."""
        if not self.config.has("bs"):
            raise ValueError(
                "Specify batch size as 'bs' in the configuration file, or "
                "override this function")
        return self.config.get_int("bs")

    def _load_item(self, id_):
        raise NotImplementedError

    # Image-like [0,1] float fields quantized to uint8 in the disk cache
    # (1/255 quantization — the sources are 8-bit PNGs anyway); warp
    # stays float16 (its on-disk precision).
    _DISK_U8_MAX_ERR = 1.0 / 255.0
    _BLOB_MAGIC = b"NLTB"
    _BLOB_VERSION = 1

    def _disk_cache_path(self, id_):
        return os.path.join(
            self._disk_cache_dir, id_.replace("/", "__") + ".blob")

    def _blob_encode_field(self, k, v):
        """Returns (enc, stored array) per the quantization rules."""
        if v.dtype == np.float32 and k == "warp":
            return "q16", np.ascontiguousarray(v.astype(np.float16))
        if (v.dtype == np.float32 and v.size and v.min() >= 0.0
                and v.max() <= 1.0):
            return "q8", np.round(v * 255.0).astype(np.uint8)
        # incl. natively-uint8 device_normalize data and f16 warps
        return "raw", np.ascontiguousarray(v)

    def _disk_cache_save(self, id_, item):
        path = self._disk_cache_path(id_)
        fields, payload, strs = [], [], {}
        offset = 0
        for k, v in item.items():
            if isinstance(v, str):
                strs[k] = v
                continue
            enc, stored = self._blob_encode_field(k, v)
            fields.append({
                "name": k, "dtype": stored.dtype.name,
                "shape": list(v.shape), "enc": enc,
                "offset": offset, "nbytes": stored.nbytes})
            payload.append(stored)
            offset += stored.nbytes
        header = json.dumps({"fields": fields, "strs": strs}).encode()
        tmp = "%s.tmp%d" % (path, threading.get_ident())
        with open(tmp, "wb") as h:
            h.write(self._BLOB_MAGIC)
            h.write(struct.pack("<II", self._BLOB_VERSION, len(header)))
            h.write(header)
            for stored in payload:
                h.write(stored)
        os.replace(tmp, path)

    def _blob_header(self, h):
        """Reads and validates the header; returns (header dict,
        payload start) or None if the file is not a valid blob."""
        head = h.read(12)
        if len(head) != 12 or head[:4] != self._BLOB_MAGIC:
            return None
        version, header_len = struct.unpack("<II", head[4:])
        if version != self._BLOB_VERSION:
            return None
        header = json.loads(h.read(header_len))
        return header, 12 + header_len

    @staticmethod
    def _blob_decode(enc, stored, out=None):
        """Decodes a stored field; writes into `out` when given."""
        if enc == "q8":
            if out is None:
                return stored.astype(np.float32) / np.float32(255.0)
            np.divide(stored, np.float32(255.0), out=out)
            return out
        if enc == "q16":
            if out is None:
                return stored.astype(np.float32)
            out[...] = stored
            return out
        if out is None:
            return stored
        out[...] = stored
        return out

    def _disk_cache_load(self, id_):
        path = self._disk_cache_path(id_)
        try:
            with open(path, "rb") as h:
                parsed = self._blob_header(h)
                if parsed is None:
                    return None
                header, _ = parsed
                item = dict(header["strs"])
                for f in header["fields"]:
                    stored = np.empty(
                        f["shape"], np.dtype(f["dtype"]))
                    if h.readinto(stored) != f["nbytes"]:
                        return None
                    item[f["name"]] = self._blob_decode(f["enc"], stored)
                return item
        except OSError:
            return None

    def _blob_read_into(self, id_, arrays, strs, i):
        """Fast warm path: stream a cached example straight into batch
        slot `i` (page cache -> batch buffer, no intermediate example
        dict). Returns False if the blob is missing/stale (caller falls
        back to the full loader, which rewrites it)."""
        path = self._disk_cache_path(id_)
        try:
            with open(path, "rb") as h:
                parsed = self._blob_header(h)
                if parsed is None:
                    return False
                header, payload_at = parsed
                for f in header["fields"]:
                    k = f["name"]
                    out = arrays.get(k)
                    if out is None or list(out.shape[1:]) != f["shape"]:
                        return False  # stale schema
                    h.seek(payload_at + f["offset"])
                    if f["enc"] == "raw":
                        if (np.dtype(f["dtype"]) != out.dtype
                                or h.readinto(out[i]) != f["nbytes"]):
                            return False
                    else:
                        stored = np.empty(
                            f["shape"], np.dtype(f["dtype"]))
                        if h.readinto(stored) != f["nbytes"]:
                            return False
                        self._blob_decode(f["enc"], stored, out=out[i])
                # Coverage: every schema field must come from the blob
                # (a blob predating a new field would otherwise leave
                # np.empty garbage in that field's batch slot).
                blob_fields = {f["name"] for f in header["fields"]}
                if set(arrays) - blob_fields:
                    return False
                if set(strs) - set(header["strs"]):
                    return False
                for k, v in header["strs"].items():
                    strs[k][i] = v
                return True
        except (OSError, ValueError, KeyError):
            # Unreadable or stale blob (e.g. dtype/shape drift): fall
            # back to the full loader, which rewrites it.
            return False

    def _load_cached(self, id_):
        if self.cache_enabled == "ram":
            with self._cache_lock:
                if id_ in self._cache:
                    return self._cache[id_]
        elif self.cache_enabled == "disk":
            item = self._disk_cache_load(id_)
            if item is not None:
                return item
        item = self._load_item(id_)
        if self.cache_enabled == "ram":
            with self._cache_lock:
                self._cache[id_] = item
        elif self.cache_enabled == "disk":
            self._disk_cache_save(id_, item)
        return item

    def _ensure_schema(self, first_id):
        """Discovers the (dtype, shape) of every field from one example
        (cached across epochs)."""
        if self._schema is not None:
            return
        with self._schema_lock:
            if self._schema is not None:
                return
            item = self._load_cached(first_id)
            arrays, strs = {}, []
            for k, v in item.items():
                if isinstance(v, np.ndarray):
                    arrays[k] = (v.dtype, tuple(v.shape))
                else:
                    strs.append(k)
            self._schema = (arrays, strs)

    def _alloc_batch(self, bs):
        arrays = {k: np.empty((bs,) + shape, dt)
                  for k, (dt, shape) in self._schema[0].items()}
        strs = {k: [None] * bs for k in self._schema[1]}
        return arrays, strs

    def _fill_slot(self, id_, arrays, strs, i):
        """Loads one example directly into batch slot `i` (runs on a
        worker thread; slots are disjoint, so no locking)."""
        if (self.cache_enabled == "disk"
                and self._blob_read_into(id_, arrays, strs, i)):
            return
        item = self._load_cached(id_)
        for k, v in item.items():
            if isinstance(v, np.ndarray):
                arrays[k][i] = v
            else:
                strs[k][i] = v

    def __len__(self):
        return len(self.files)

    def n_batches(self, drop_remainder=True):
        if drop_remainder:
            return len(self.files) // self.bs
        return -(-len(self.files) // self.bs)

    def iterate(self, seed=None, no_batch=False, drop_remainder=True,
                shard_id=0, num_shards=1):
        """One epoch of batches. Train mode shuffles with `seed`.

        Several processes: pass (rank, world size) so each loads a
        disjoint slice of each (seed-synchronized) global shuffle and a
        1/num_shards-sized local batch (the port drives one process;
        distribution is ROADMAP queue 1, item 5).
        """
        ids = sorted(self.files)
        if self.mode == "train":
            rng = np.random.RandomState(seed)
            rng.shuffle(ids)

        # Batch geometry is derived from the GLOBAL id list, so every
        # host of a sharded run computes the same batch count and the
        # same per-host batch size — the collective train loop would
        # otherwise desync on len(ids) % num_shards != 0. Each global
        # batch is then sliced per host.
        if no_batch:
            assert num_shards == 1, "no_batch is a single-process path"
            gbs = 1
        else:
            gbs = self.bs
            if num_shards > 1:
                assert gbs % num_shards == 0, (
                    "Global batch %d not divisible by %d hosts"
                    % (gbs, num_shards))
        chunks = [ids[b * gbs:(b + 1) * gbs]
                  for b in range(len(ids) // gbs)]
        rem = ids[(len(ids) // gbs) * gbs:]
        if rem and (not drop_remainder or not chunks):
            if num_shards > 1 and len(rem) % num_shards != 0:
                if not chunks:
                    raise ValueError(
                        "%d examples cannot be evenly sharded over %d "
                        "hosts" % (len(rem), num_shards))
                logger.warn(
                    "Dropping %d remainder examples (not divisible "
                    "across %d hosts)", len(rem), num_shards)
            else:
                chunks.append(rem)
        if num_shards > 1:
            chunks = [c[shard_id::num_shards] for c in chunks]

        out_q = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def producer():
            try:
                self._ensure_schema(chunks[0][0])
                with ThreadPoolExecutor(self.n_workers) as pool:
                    for chunk in chunks:
                        if stop.is_set():
                            return
                        arrays, strs = self._alloc_batch(len(chunk))
                        # Workers write straight into their batch slot.
                        list(pool.map(
                            lambda t: self._fill_slot(
                                t[1], arrays, strs, t[0]),
                            enumerate(chunk)))
                        batch = {**arrays, **strs}
                        if no_batch:
                            batch = {k: v[0] for k, v in batch.items()}
                        out_q.put(batch)
            except Exception as e:  # surface loader errors to the consumer
                out_q.put(e)
            finally:
                # The consumer may have gone away with the queue full;
                # never block forever on the end-of-epoch sentinel.
                while not stop.is_set():
                    try:
                        out_q.put(None, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # Drain so the producer can exit.
            while thread.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
