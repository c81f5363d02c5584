"""Plotting helpers of the port: for now only the norm-vector check that the
graph commands share (``style.check_norm_compat``); the plots come with their
own slice."""
