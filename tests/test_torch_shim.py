"""The watchdog of ``tools/rehearse_kernels.py``'s shim in concurrent mode.

A thread of a concurrent shim launch that spins on a flag aborts after
``REHEARSE_SPIN_LIMIT_S`` seconds (60 by default) of one wait: counted
from the last change of the value it loads, not from its first load.  A
two-block launch, built with the limit lowered to 1 s, shows both sides:
a waiter that sees the flag advance every 0.3 s, six waits that sum past
the limit, runs to its end; a waiter whose last value is never published
aborts with the watchdog's message.  Each case runs in a subprocess, since
an abort ends the process.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: block 0 publishes 1, 2, .. `published` on the flag, a pause before each;
#: block 1 waits for each of 1, 2, .. `waited` in turn
SPIN = r"""
#include <chrono>
#include <cuda/atomic>
#include <cuda_runtime.h>
#include <thread>

namespace {

__global__ void spin_kernel(int* flag, int published, int waited, int pause_ms) {
  cuda::atomic_ref<int, cuda::thread_scope_device> f(*flag);
  if (blockIdx.x == 0) {
    for (int k = 1; k <= published; ++k) {
      std::this_thread::sleep_for(std::chrono::milliseconds(pause_ms));
      f.store(k, cuda::std::memory_order_release);
    }
  } else {
    for (int k = 1; k <= waited; ++k) {
      while (f.load(cuda::std::memory_order_acquire) < k) {
      }
    }
  }
}

}  // namespace

extern "C" int spin_wait(void* flag, int published, int waited, int pause_ms) {
  spin_kernel<<<2, 1, 0, nullptr>>>(static_cast<int*>(flag), published, waited, pause_ms);
  return 0;
}
"""

RUN = """
import ctypes, sys
sys.path.insert(0, {tools!r})
import rehearse_kernels
dll = rehearse_kernels.build({out!r}, sources=("spin.cu",), src_dir={src!r},
                             defines=("REHEARSE_SPIN_LIMIT_S=1",))
dll.rehearse_concurrent(1)
flag = ctypes.c_int(0)
dll.spin_wait(ctypes.byref(flag), {published}, {waited}, 300)
print("done", flag.value)
"""


def _run(tmp_path, published: int, waited: int) -> subprocess.CompletedProcess:
    (tmp_path / "spin.cu").write_text(SPIN)
    script = RUN.format(tools=os.path.join(ROOT, "tools"), out=str(tmp_path / "build"),
                        src=str(tmp_path), published=published, waited=waited)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(script)], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("published, waited, aborts", [(6, 6, False), (2, 3, True)],
                         ids=["short waits past the limit", "one wait past the limit"])
def test_watchdog_counts_one_wait(tmp_path, published, waited, aborts):
    """Six waits of 0.3 s each (1.8 s in all, past the 1 s limit) end
    normally; a wait for a value never published aborts after 1 s."""
    out = _run(tmp_path, published, waited)
    if aborts:
        assert out.returncode != 0
        assert "rehearse: a thread spins on a flag for 1 s" in out.stderr
    else:
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["done", str(published)]
