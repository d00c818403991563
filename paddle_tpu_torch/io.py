"""Model persistence — the port of ``paddle_tpu/io.py``: ``save_vars`` /
``save_params`` / ``save_persistables`` and their ``load_*`` twins (a
program of ``save`` / ``load`` host ops run by the executor), the
checkpoint serial helpers (exclusive serial claim, md5 ``_MANIFEST``,
durable commit, verification, trim) and ``save_checkpoint`` /
``load_checkpoint``. The serial layout is the reference's, byte for
byte in its schema: a serial written by either package loads in the
other. The inference-model export is not ported yet.
"""

import json
import os

from .framework import Parameter, Program, default_main_program

__all__ = ["save_vars", "save_params", "save_persistables", "load_vars",
           "load_params", "load_persistables", "save_checkpoint",
           "load_checkpoint"]


def is_persistable(var):
    return var.persistable


def is_parameter(var):
    return isinstance(var, Parameter)


def _build_save_program(vars_list, dirname, filename=None):
    prog = Program()
    block = prog.global_block()
    for v in vars_list:
        block.create_var(name=v.name, shape=v.shape, dtype=v.dtype,
                         persistable=True)
    if filename is None:
        for v in vars_list:
            block.append_op(type="save", inputs={"X": [v.name]}, outputs={},
                            attrs={"file_path": os.path.join(dirname, v.name)},
                            infer_shape=False)
    else:
        block.append_op(type="save_combine",
                        inputs={"X": [v.name for v in vars_list]}, outputs={},
                        attrs={"file_path": os.path.join(dirname, filename)},
                        infer_shape=False)
    return prog


def _build_load_program(vars_list, dirname, filename=None):
    prog = Program()
    block = prog.global_block()
    for v in vars_list:
        block.create_var(name=v.name, shape=v.shape, dtype=v.dtype,
                         persistable=True)
    if filename is None:
        for v in vars_list:
            block.append_op(type="load", inputs={},
                            outputs={"Out": [v.name]},
                            attrs={"file_path": os.path.join(dirname, v.name)},
                            infer_shape=False)
    else:
        block.append_op(type="load_combine", inputs={},
                        outputs={"Out": [v.name for v in vars_list]},
                        attrs={"file_path": os.path.join(dirname, filename)},
                        infer_shape=False)
    return prog


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    if vars is None:
        main_program = main_program or default_main_program()
        vars = list(filter(predicate, main_program.list_vars()))
    vars = [v for v in vars if v.name != "fetch" and v.name != "feed"]
    os.makedirs(dirname, exist_ok=True)
    executor.run(_build_save_program(vars, dirname, filename))


def save_params(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, predicate=is_parameter,
              filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, predicate=is_persistable,
              filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    if vars is None:
        main_program = main_program or default_main_program()
        vars = list(filter(predicate, main_program.list_vars()))
    vars = [v for v in vars if v.name != "fetch" and v.name != "feed"]
    executor.run(_build_load_program(vars, dirname, filename))


def load_params(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=is_parameter,
              filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=is_persistable,
              filename=filename)


def _fsync_path(path, strict=False):
    """fsync a file OR directory. Files: flush written bytes to stable
    storage. Directories: make the rename/creation just performed
    inside durable (an os.replace is atomic but not durable until the
    directory entry itself is synced).

    ``strict=True`` (tensor files about to be vouched for by a durable
    manifest) PROPAGATES fsync failures — an EIO swallowed here would
    let the manifest commit over bytes that never reached disk.
    ``strict=False`` (directory entries) stays best-effort: some
    filesystems refuse directory fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        if strict:
            raise
        return
    try:
        os.fsync(fd)
    except OSError:
        if strict:
            raise
    finally:
        os.close(fd)


def _claim_serial_dir(checkpoint_dir):
    """Exclusively claim the next checkpoint serial: concurrent writers
    (any trainer) get DISTINCT serials instead of interleaving writes
    into one dir that would then md5-verify as a mixed checkpoint.
    Returns (serial, path)."""
    while True:
        serials = [int(s) for s in os.listdir(checkpoint_dir)
                   if s.isdigit()]
        serial = (max(serials) + 1) if serials else 0
        cur = os.path.join(checkpoint_dir, str(serial))
        try:
            os.makedirs(cur, exist_ok=False)
            return serial, cur
        except FileExistsError:
            continue  # another trainer claimed it; take the next serial


def _trim_old_serials(checkpoint_dir, serial, keep):
    """Keep the ``keep`` newest serials. RE-LISTS after ``serial``'s
    commit (a pre-write snapshot can be stale under concurrent claims)
    and deletes only serials strictly OLDER than ours — a concurrent
    trainer's newer serial is never ours to delete."""
    import shutil
    older = sorted(int(s) for s in os.listdir(checkpoint_dir)
                   if s.isdigit() and int(s) < serial)
    for s in older[: max(0, len(older) + 1 - keep)]:
        shutil.rmtree(os.path.join(checkpoint_dir, str(s)),
                      ignore_errors=True)


def _commit_manifest(checkpoint_dir, cur, manifest):
    """Durably COMMIT a checkpoint serial: write the manifest to a tmp
    file, fsync it, atomically rename it into place, then fsync the
    serial dir and the checkpoint root so both the rename and the
    serial's creation survive power loss. The caller must already have
    fsynced the tensor bytes the manifest vouches for — this ordering
    (data stable before the record that validates it) is the crash-
    consistency invariant both checkpoint writers share."""
    mpath = os.path.join(cur, "_MANIFEST")
    with open(mpath + ".tmp", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(mpath + ".tmp", mpath)
    _fsync_path(cur)
    _fsync_path(checkpoint_dir)
    return mpath


def _verify_serial(cur):
    """Verify one serial dir against its ``_MANIFEST``. Returns the
    manifest dict when present and every TRACKED file's md5 matches
    (stray temp files — .nfs silly-renames etc. — are ignored: only
    manifest-tracked files gate validity). Returns None when no
    manifest exists (torn / pre-manifest serial; callers choose their
    policy). Raises on corruption: a torn manifest (json error) or an
    md5 mismatch naming the offending files. THE one verify rule both
    ``load_checkpoint`` and ``CheckpointManager.latest_valid`` use."""
    mpath = os.path.join(cur, "_MANIFEST")
    if not os.path.exists(mpath):
        return None
    with open(mpath) as f:
        manifest = json.load(f)  # a torn manifest raises = corruption
    tracked = manifest["md5"]
    actual = _checkpoint_manifest(cur)
    bad = sorted(k for k in tracked if actual.get(k) != tracked[k])
    if bad:
        raise IOError("checkpoint %r fails md5 verification (%s)"
                      % (cur, bad[:4]))
    return manifest


def _checkpoint_manifest(dirname):
    """name → md5 of every tensor file in a checkpoint directory."""
    import hashlib
    digests = {}
    for fn in sorted(os.listdir(dirname)):
        path = os.path.join(dirname, fn)
        if fn == "_MANIFEST" or not os.path.isfile(path):
            continue
        h = hashlib.md5()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        digests[fn] = h.hexdigest()
    return digests


def save_checkpoint(executor, checkpoint_dir, trainer_id=0,
                    main_program=None, max_num_checkpoints=3):
    """Versioned training checkpoints: a serial dir of the persistables
    and a ``_MANIFEST`` of their md5 digests and a timestamp, committed
    durably; the oldest serials beyond ``max_num_checkpoints`` trimmed."""
    import time as _time
    os.makedirs(checkpoint_dir, exist_ok=True)
    serial, cur = _claim_serial_dir(checkpoint_dir)
    save_persistables(executor, cur, main_program)
    # tensor bytes must be stable BEFORE the manifest that vouches for
    # them — a durable manifest over non-durable tensors would md5-fail
    # the whole serial after power loss
    for fn in os.listdir(cur):
        path = os.path.join(cur, fn)
        if os.path.isfile(path):
            _fsync_path(path, strict=True)
    manifest = {"trainer_id": trainer_id, "timestamp": _time.time(),
                "md5": _checkpoint_manifest(cur)}
    _commit_manifest(checkpoint_dir, cur, manifest)
    _trim_old_serials(checkpoint_dir, serial, max_num_checkpoints)
    return serial


def load_checkpoint(executor, checkpoint_dir, serial=None, main_program=None,
                    verify=True):
    """Load the latest (or given) checkpoint serial; ``verify`` checks the
    md5 manifest first and falls back to the previous serial on corruption
    (the go-pserver recovery behavior)."""
    serials = sorted(int(s) for s in os.listdir(checkpoint_dir)
                     if s.isdigit())
    if not serials:
        raise FileNotFoundError("no checkpoints in %r" % checkpoint_dir)
    candidates = [serial] if serial is not None else list(reversed(serials))
    last_err = None
    errors = []  # (serial, error) per corrupt candidate, for the warning
    for s in candidates:
        cur = os.path.join(checkpoint_dir, str(s))
        try:
            if verify:
                # a torn/partial manifest or md5 mismatch counts as
                # corruption of this serial, not a fatal error (crash
                # mid-save). No manifest at all (pre-manifest or
                # crash-before-manifest checkpoint): attempt the load;
                # failures fall through to the previous serial below
                _verify_serial(cur)
            load_persistables(executor, cur, main_program)
        except Exception as e:  # corrupt serial → try the previous one
            last_err = e
            errors.append((s, e))
            continue
        if s != candidates[0]:
            import warnings
            warnings.warn(
                "checkpoint serial(s) %s corrupt; resumed from serial %d "
                "instead" % ("; ".join("%s (%s)" % (cs, ce)
                                       for cs, ce in errors), s))
        return s
    raise last_err or FileNotFoundError(
        "no loadable checkpoint in %r" % checkpoint_dir)
