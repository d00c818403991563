"""Unique name generation for IR variables — a copy of
``paddle_tpu/unique_name.py`` with the same scheme (``key_0, key_1, ...``
per key), so one build script run in both packages names every variable
alike (the parity tests map parameters by name)."""

import contextlib
import threading


class UniqueNameGenerator:
    """Generates names like ``prefix_0, prefix_1, ...`` per prefix."""

    def __init__(self, prefix=""):
        self.prefix = prefix
        self.ids = {}
        self._lock = threading.Lock()

    def __call__(self, key):
        with self._lock:
            idx = self.ids.setdefault(key, 0)
            self.ids[key] += 1
        return "_".join([self.prefix + key, str(idx)]) if self.prefix else "%s_%d" % (key, idx)


_generator = UniqueNameGenerator()


def generate(key):
    return _generator(key)


def switch(new_generator=None):
    global _generator
    old = _generator
    _generator = new_generator if new_generator is not None else UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
