"""Device ms per traced unit of work in every operation other than the two
count kernels and the Gram's products: the normalize chain, the row
standardization, the adds of the Gram's pieces, the divide and copies."""

import re

from kbench import registry

SKIP = ("count_kmers_smem", "count_kmers_hiblocked", "gram")


def read(rec):
    if rec["trace"] is None or not rec["trace"]["events"] or not rec["units_traced"]:
        return None
    skip = [re.compile(registry.roofline(k).KERNEL) for k in SKIP]
    seconds = sum(e - s for name, s, e in rec["trace"]["events"]
                  if not any(rx.search(name) for rx in skip))
    return 1e3 * seconds / rec["units_traced"]
