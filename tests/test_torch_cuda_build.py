"""The kernel loader of the port (`os2d_torch.ops.cuda.CudaKernel`) under
concurrent first launches, as a server's request threads make them: each
library is built once and loaded once, and every launch is counted. nvcc
and the library are stubbed (`build_all`, `ctypes.CDLL`), so this runs
without a card."""

import sys
import threading
import time
from unittest import mock

from os2d_torch.ops import cuda

THREADS = 8


def _run_together(fn):
    barrier = threading.Barrier(THREADS)
    errors = []

    def run():
        try:
            barrier.wait(10)
            fn()
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run) for _ in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_concurrent_first_calls_build_and_load_once():
    builds, loads = [], []

    def fake_build(sources):
        builds.append(list(sources))
        time.sleep(0.05)  # nvcc takes seconds: widen the window
        return {}

    def fake_cdll(path):
        loads.append(path)
        lib = mock.MagicMock()
        getattr(lib, "os2d_test_kernel").return_value = 0
        return lib

    kernel = cuda.CudaKernel("resample.cu", "os2d_test_kernel", [])
    with mock.patch.object(cuda, "build_all", fake_build), \
            mock.patch.object(cuda.ctypes, "CDLL", fake_cdll):
        fns = []
        _run_together(lambda: fns.append(kernel._function()))
        # one build, of every source at once
        assert builds == [cuda.all_sources()] and "resample.cu" in builds[0]
        assert len(loads) == 1
        assert len(fns) == THREADS and all(f is fns[0] for f in fns)

        # and the launch count stays exact under concurrent launches
        _run_together(lambda: [kernel.launch() for _ in range(200)])
        assert kernel.launches == THREADS * 200
