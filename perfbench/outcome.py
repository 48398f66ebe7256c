"""What a generator hands back to the harness once its window has closed."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List


@dataclasses.dataclass
class Outcome:
    setup_end: float                  # host clock: set-up done, window opens
    end_to_end: Dict[str, float]      # every end-to-end metric it can read
    samples: Dict[str, List[float]]   # raw samples a ``<x>_p<q>_<unit>``
    # metric takes its percentile of (``"<x>_<unit>"``)
    attempted: int
    failed: int
    session: Any          # what the per-layer readers read; its
    # ``release()`` frees the program's state, its ``check(done)`` has
    # the reference judge a sample of ``done``, its ``breakdown()`` gives
    # the traced stretch's device operations and idle gaps
    done: List[Any]       # the finished requests the check may judge
