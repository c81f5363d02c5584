"""Device ms per traced unit of work in every operation other than the count
kernel and the Gram: the normalize chain, the row standardization, copies."""

import re

from kbench import registry


def read(rec):
    if rec["trace"] is None or not rec["trace"]["events"] or not rec["units_traced"]:
        return None
    skip = [re.compile(registry.roofline(k).KERNEL) for k in ("count_kmers_smem", "gram")]
    seconds = sum(e - s for name, s, e in rec["trace"]["events"]
                  if not any(rx.search(name) for rx in skip))
    return 1e3 * seconds / rec["units_traced"]
