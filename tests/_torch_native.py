"""Load gelly_tpu's native libraries for the port's tests.

gelly_tpu builds ``native/lib<stem>.so`` at first use with ``g++ -o`` on
the final path, and caches a failed probe for the process's life
(``gelly_tpu.utils.native._AVAILABLE``). Under xdist several test
processes can build or load one library at once; a process whose probe
opens a half-written file would then run gelly_tpu's fallback paths for
the rest of the session. :func:`load_jax_native` makes a lost race a
wait: a failed probe is dropped from the cache and retried, and only a
library that never loads fails the caller.
"""

import time

from gelly_tpu.utils import native as jnative


def load_jax_native(*stems: str, tries: int = 8,
                    wait_s: float = 0.5) -> None:
    for stem in stems:
        for attempt in range(tries):
            if jnative.available(stem):
                break
            jnative._AVAILABLE.pop(stem, None)
            time.sleep(wait_s * (attempt + 1))
        else:
            raise AssertionError(
                f"gelly_tpu's native library {stem!r} did not load after "
                f"{tries} tries")
