"""The port's command line: ``python -m seekr_tpu_torch.cli <command> [args]``.

Six commands of ``seekr_tpu/cli.py``, with its flags and defaults and the same
file contracts (counts CSV/npy, mean/std npy, pearson npy/csv, fitres CSV,
p-value CSV):

  main path    kmer_counts, norm_vectors, pearson
  statistics   find_dist, find_pval, adj_pval

One flag is the port's own: ``--device`` (default: the first CUDA card; ``cpu``
runs on the CPU).  Every command resolves it first, so without a card and
without ``--device cpu`` a command raises instead of moving to the CPU on its
own; adj_pval, which runs on the host, holds the same rule.  Not in this port
yet, and refused with an error that names the slice they come with:
``adj_pval -bi/-bo/--symmetric`` (the streamed correction), ``find_dist -pf``
(the fit plot), and ``-dp``/``-kp`` above 1 (the device mesh).
A bare command prints its help.
"""

from __future__ import annotations

import argparse
import csv
import sys

LOG2_CHOICES = ["Log2.post", "Log2.pre", "Log2.none"]
DEVICE_HELP = ("where counting and Pearson run: a torch device such as 'cuda:0' "
               "or 'cpu' (default: the first CUDA card)")
STREAM_ADJ_SLICE = "the port's streamed adj_pval slice (stats/stream_adj)"
MESH_SLICE = "the port's multi-GPU slice"

KMER_COUNTS_DOC = """
Generate the m x 4^k k-mer count matrix of a fasta file: one row per
transcript, columns in AGTC product order, counts per kb of windows,
optionally mean-centered, standardized, and log2-transformed (Log2.post by
default).  The counting runs as a CUDA kernel on the card.  Output is a
labeled CSV by default; -b switches to a binary .npy, -rl drops the labels.

  $ python -m seekr_tpu_torch.cli kmer_counts rnas.fa -o out_counts.csv
  $ python -m seekr_tpu_torch.cli kmer_counts rnas.fa -o out.npy -k 4 -b
  $ python -m seekr_tpu_torch.cli kmer_counts rnas.fa -o raw.csv -uc -us -l Log2.none
  $ python -m seekr_tpu_torch.cli kmer_counts rnas.fa -o out.csv -mv mean.npy -sv std.npy
"""

NORM_VECTORS_DOC = """
Compute the per-k-mer mean and standard-deviation vectors of a (typically
large background) fasta and save them as two .npy files.

  $ python -m seekr_tpu_torch.cli norm_vectors gencode.fa -k 5 -mv mean_5mers.npy -sv std_5mers.npy
"""

PEARSON_DOC = """
All-pairs Pearson correlation between the rows of two k-mer count artifacts:
an [m1, n] and an [m2, n] matrix give an [m1, m2] r-matrix.  Labeled CSV in
and out by default; -bi reads .npy, -bo writes .npy.  Outputs beyond ~64M
cells stream to disk in row blocks.

  $ python -m seekr_tpu_torch.cli pearson counts1.csv counts2.csv -o pearson.csv
  $ python -m seekr_tpu_torch.cli pearson counts1.npy counts2.npy -o pearson.npy -bi -bo
"""

FIND_DIST_DOC = """
Model the null distribution of pairwise similarities: count a background
fasta, correlate it against itself, take the upper triangle of r-values
(subsampled to -sbs values when -sbt is set), and fit candidate scipy
distributions ranked by goodness of fit.  Saves bkg_mean_{k}mers.npy /
bkg_std_{k}mers.npy in the working directory.  Without -fm the raw r-values
are saved instead: the empirical background for find_pval.

  $ python -m seekr_tpu_torch.cli find_dist background.fa -k 4 -fm -o fitres
  $ python -m seekr_tpu_torch.cli find_dist background.fa -k 4 -sbt -o bkg_rvalues
"""

FIND_PVAL_DOC = """
P-values for the pairwise similarities of two fastas, against either the
-bf-th best distribution of a find_dist fitres file (p = 1 - cdf(r)) or an
empirical r-value sample (-ft npy).  Output is a labeled CSV of sequence1 x
sequence2 p-values.

  $ python -m seekr_tpu_torch.cli find_pval a.fa b.fa mean_4.npy std_4.npy 4 fitres.csv -o pvals
  $ python -m seekr_tpu_torch.cli find_pval a.fa b.fa mean_4.npy std_4.npy 4 bkg_rvalues.csv -ft npy -o pvals
"""

ADJ_PVAL_DOC = """
Multiple-comparison correction of a find_pval matrix.  Symmetric inputs
correct only the upper triangle and fill the rest with NaN; asymmetric inputs
correct the full flattened matrix.  Methods: bonferroni, sidak, holm,
holm-sidak, simes-hochberg, hommel, fdr_bh, fdr_by, fdr_tsbh, fdr_tsbky.

  $ python -m seekr_tpu_torch.cli adj_pval pvals.csv fdr_bh -o adj_pvals
"""


def _parse_args_or_exit(parser, argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        parser.print_help()
        sys.exit(0)
    return parser.parse_args(argv)


def _parser(doc) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        usage=doc, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--device", default=None, help=DEVICE_HELP)
    return parser


def _device(args):
    from seekr_tpu_torch.utils.device import resolve_device

    return resolve_device(args.device)


def _refuse_mesh(parser, args, *flags):
    for flag in flags:
        value = getattr(args, flag)
        if value is not None and value > 1:
            parser.error(f"--{flag} {value}: the device mesh comes with {MESH_SLICE}")


# -- kmer_counts -------------------------------------------------------------

def _run_kmer_counts(fasta, outfile, kmer, binary, centered, standardized,
                     log2, remove_labels, mean_vector, std_vector, alphabet,
                     device):
    from seekr_tpu_torch.models.counter import KmerCounter

    mean = mean_vector or centered
    std = std_vector or standardized
    counter = KmerCounter(fasta, outfile, kmer, binary, mean, std, log2,
                          label=not remove_labels, alphabet=alphabet, device=device)
    counter.make_count_file()


def console_kmer_counts(argv=None):
    parser = _parser(KMER_COUNTS_DOC)
    parser.add_argument("fasta", help="Full path of fasta file.")
    parser.add_argument("-o", "--outfile", default="counts.seekr",
                        help="Name of file to save counts to.")
    parser.add_argument("-k", "--kmer", default=6,
                        help="Length of kmers you want to count.")
    parser.add_argument("-b", "--binary", action="store_true",
                        help="Set if output should be a .npy file.")
    parser.add_argument("-uc", "--uncentered", action="store_false",
                        help="Set if output should not have the mean subtracted.")
    parser.add_argument("-us", "--unstandardized", action="store_false",
                        help="Set if output should not be divided by the "
                             "standard deviation.")
    parser.add_argument("-l", "--log2", default="Log2.post", choices=LOG2_CHOICES,
                        help="Decided if and when to log transform counts")
    parser.add_argument("-rl", "--remove_labels", action="store_true",
                        help="Set to save without index and column labels.")
    parser.add_argument("-mv", "--mean_vector", default=None,
                        help="Optional path to mean vector numpy file.")
    parser.add_argument("-sv", "--std_vector", default=None,
                        help="Optional path to std vector numpy file.")
    parser.add_argument("-a", "--alphabet", default="AGTC",
                        help="Valid letters to include in kmer.")
    args = _parse_args_or_exit(parser, argv)
    _run_kmer_counts(args.fasta, args.outfile, int(args.kmer), args.binary,
                     args.uncentered, args.unstandardized, args.log2,
                     args.remove_labels, args.mean_vector, args.std_vector,
                     args.alphabet, _device(args))


# -- pearson -----------------------------------------------------------------

def _run_pearson(counts1, counts2, outfile, binary_input, binary_output, device):
    import numpy as np

    from seekr_tpu_torch.io.fast_csv import read_labeled_csv, write_labeled_csv
    from seekr_tpu_torch.io.stream import (STREAM_CELL_THRESHOLD, StreamingCsvWriter,
                                           StreamingNpyWriter, stream_pearson)
    from seekr_tpu_torch.models.pearson import pearson

    if binary_input:
        counts1, counts2 = np.load(counts1), np.load(counts2)
        names1, names2 = range(counts1.shape[0]), range(counts2.shape[0])
    else:
        labeled1, labeled2 = read_labeled_csv(counts1), read_labeled_csv(counts2)
        counts1, counts2 = labeled1.values, labeled2.values
        names1, names2 = labeled1.index, labeled2.index

    if counts1.shape[0] * counts2.shape[0] > STREAM_CELL_THRESHOLD:
        if binary_output:
            writer = StreamingNpyWriter(outfile, (counts1.shape[0], counts2.shape[0]))
        else:
            writer = StreamingCsvWriter(outfile, columns=names2, row_labels=names1,
                                        fmt="%s")
        with writer:
            stream_pearson(np.asarray(counts1, dtype=np.float32),
                           np.asarray(counts2, dtype=np.float32), writer,
                           device=device)
        return

    if binary_output:
        pearson(counts1, counts2, outfile=outfile, device=device)
    else:
        write_labeled_csv(outfile, pearson(counts1, counts2, device=device),
                          names1, names2)


def console_pearson(argv=None):
    parser = _parser(PEARSON_DOC)
    parser.add_argument("counts1", help="Count file from kmer_counts.")
    parser.add_argument("counts2", help="Second count file (may equal the first).")
    parser.add_argument("-o", "--outfile", default="pearson.seekr",
                        help="Path of file to save similarities to.")
    parser.add_argument("-bi", "--binary_input", action="store_true",
                        help="Set if the input will be a .npy file.")
    parser.add_argument("-bo", "--binary_output", action="store_true",
                        help="Set if output should be a .npy file.")
    args = _parse_args_or_exit(parser, argv)
    _run_pearson(args.counts1, args.counts2, args.outfile, args.binary_input,
                 args.binary_output, _device(args))


# -- norm_vectors ------------------------------------------------------------

def _run_norm_vectors(fasta, mean_vector, std_vector, log2, kmer, device):
    import numpy as np

    from seekr_tpu_torch.models.counter import KmerCounter

    counter = KmerCounter(fasta, k=int(kmer), log2=log2, device=device)
    # sets .mean/.std: only the two [4^k] vectors cross to the host, never the
    # [m, 4^k] normalized matrix this command does not use
    counter.get_counts_device()
    np.save(mean_vector, counter.mean)
    np.save(std_vector, counter.std)


def console_norm_vectors(argv=None):
    parser = _parser(NORM_VECTORS_DOC)
    parser.add_argument("fasta", help="path to .fa file")
    parser.add_argument("-mv", "--mean_vector", default="mean.npy",
                        help="path to output mean vector")
    parser.add_argument("-sv", "--std_vector", default="std.npy",
                        help="path to output standard deviation vector")
    parser.add_argument("-l", "--log2", default="Log2.post", choices=LOG2_CHOICES,
                        help="Decided if and when to log transform counts")
    parser.add_argument("-k", "--kmer", default=6,
                        help="length of kmers you want to count")
    args = _parse_args_or_exit(parser, argv)
    _run_norm_vectors(args.fasta, args.mean_vector, args.std_vector,
                      args.log2, int(args.kmer), _device(args))


# -- find_dist ---------------------------------------------------------------

def console_find_dist(argv=None):
    parser = _parser(FIND_DIST_DOC)
    parser.add_argument("fasta", help="Background fasta path, or 'default'.")
    parser.add_argument("-k", "--kmer", default=4,
                        help="length of kmers you want to count.")
    parser.add_argument("-l", "--log2", default="Log2.post", choices=LOG2_CHOICES,
                        help="decided if and when to log transform counts")
    parser.add_argument("-mdl", "--models", default="common10",
                        help="'all', 'common10', or comma-separated scipy "
                             "distribution names (e.g. 'norm,expon,pareto').")
    parser.add_argument("-sbt", "--subsetting", action="store_true",
                        help="use a subset of the data for fitting/output.")
    parser.add_argument("-sbs", "--subset_size", default=100000,
                        help="subset size when --subsetting is set.")
    parser.add_argument("-fm", "--fit_model", action="store_true",
                        help="fit the data to the --models distributions.")
    parser.add_argument("-statm", "--statsmethod", default="ks",
                        choices=["ks", "mse", "aic", "bic"],
                        help="goodness-of-fit statistic.")
    parser.add_argument("-pb", "--progress_bar", action="store_true",
                        help="show a progress bar while fitting.")
    parser.add_argument("-pf", "--plotfit", default=None,
                        help="path to save the fit grid plot (not in this port "
                             "yet: the viz slice).")
    parser.add_argument("-o", "--outputname", default=None,
                        help="path to save results csv (csv appended).")
    parser.add_argument("-nj", "--n_jobs", default=1,
                        help="host processes for distribution fitting.")
    # -fto, not -ft: find_pval binds -ft to --fitres_type
    parser.add_argument("-fto", "--fit_timeout", default=None, type=float,
                        help="per-distribution fit timeout in seconds; a "
                             "timed-out fit is skipped like any failed fit.")
    parser.add_argument("-dp", "--data_parallel", default=None, type=int,
                        help="devices on the mesh 'data' axis (above 1: not in "
                             "this port yet).")
    parser.add_argument("-kp", "--kmer_parallel", default=1, type=int,
                        help="devices on the mesh 'kmer' axis (above 1: not in "
                             "this port yet).")
    args = _parse_args_or_exit(parser, argv)
    _refuse_mesh(parser, args, "data_parallel", "kmer_parallel")
    if args.plotfit:
        parser.error("-pf/--plotfit: the fit plot comes with the port's viz slice")

    from seekr_tpu_torch.stats.find_dist import find_dist

    device = _device(args)
    models = args.models if args.models in ("common10", "all") else args.models.split(",")
    find_dist(args.fasta, int(args.kmer), args.log2, models,
              args.subsetting, int(args.subset_size), args.fit_model,
              args.statsmethod, args.progress_bar, None, args.outputname,
              n_jobs=int(args.n_jobs), fit_timeout=args.fit_timeout, device=device)


# -- find_pval ---------------------------------------------------------------

def parse_fitres_csv(fitres_file, fitres_type):
    """Reload a find_dist artifact: the distribution-list csv, or raw r-values.

    The distribution branch re-parses the stringified params tuple back into
    floats (reference console_scripts.py:862-872).
    """
    import numpy as np

    if fitres_type == "distribution":
        with open(fitres_file, newline="") as fh:
            rows = list(csv.reader(fh))[1:]
        return [(row[0], float(row[1]) if row[1] else np.nan,
                 tuple(map(float, row[2][1:-1].split(","))))
                for row in rows]
    return np.loadtxt(fitres_file, delimiter=",")


def console_find_pval(argv=None):
    parser = _parser(FIND_PVAL_DOC)
    parser.add_argument("seq1file", help="fasta file of input sequence 1.")
    parser.add_argument("seq2file", help="fasta file of input sequence 2 (may equal 1).")
    parser.add_argument("mean_path", help="normalization mean vector (.npy).")
    parser.add_argument("std_path", help="normalization std vector (.npy).")
    parser.add_argument("kmer", help="k-mer length (must match the vectors).")
    parser.add_argument("fitres_file", help="csv output of find_dist.")
    parser.add_argument("-ft", "--fitres_type", default="distribution",
                        choices=["distribution", "npy"],
                        help="type of the fitres artifact.")
    parser.add_argument("-l", "--log2", default="Log2.post", choices=LOG2_CHOICES,
                        help="decided if and when to log transform counts")
    parser.add_argument("-bf", "--bestfit", default=1,
                        help="1-based index of the distribution to use.")
    parser.add_argument("-o", "--outputname", default=None,
                        help="path to save p-value csv (csv appended).")
    parser.add_argument("-pb", "--progress_bar", action="store_true",
                        help="show a progress bar during calculation.")
    parser.add_argument("-bo", "--binary_outfile", default=None,
                        help="also write the p-value matrix as a float32 .npy.")
    parser.add_argument("--stream", default=None, choices=["auto", "on", "off"],
                        help="stream the p-value matrix block by block to the "
                             "output artifacts ('auto' streams above 64M cells; "
                             "streamed, nothing is returned, only written).")
    parser.add_argument("-dp", "--data_parallel", default=None, type=int,
                        help="devices on the mesh 'data' axis (above 1: not in "
                             "this port yet).")
    args = _parse_args_or_exit(parser, argv)
    _refuse_mesh(parser, args, "data_parallel")

    from seekr_tpu_torch.stats.find_pval import find_pval

    device = _device(args)
    fitres = parse_fitres_csv(args.fitres_file, args.fitres_type)
    stream = {None: None, "auto": None, "on": True, "off": False}[args.stream]
    find_pval(args.seq1file, args.seq2file, args.mean_path, args.std_path,
              int(args.kmer), fitres, args.log2, int(args.bestfit),
              args.outputname, args.progress_bar, stream=stream,
              npy_out=args.binary_outfile, device=device)


# -- adj_pval ----------------------------------------------------------------

def console_adj_pval(argv=None):
    parser = _parser(ADJ_PVAL_DOC)
    parser.add_argument("pval_path", help="csv of p-values (output of find_pval).")
    parser.add_argument("method",
                        help="correction method: bonferroni, sidak, "
                             "holm-sidak, holm, simes-hochberg, hommel, "
                             "fdr_bh, fdr_by, fdr_tsbh, fdr_tsbky.")
    parser.add_argument("-a", "--alpha", default=0.05,
                        help="desired family-wise error rate.")
    parser.add_argument("-o", "--outputname", default=None,
                        help="path to save adjusted csv (csv appended).")
    parser.add_argument("-bi", "--binary_input", action="store_true",
                        help="pval_path is a .npy artifact (not in this port "
                             "yet: the streamed correction).")
    parser.add_argument("-bo", "--binary_outfile", default=None,
                        help="also write the corrected matrix as .npy (-bi "
                             "mode; not in this port yet).")
    parser.add_argument("--symmetric", default="auto", choices=["auto", "yes", "no"],
                        help="-bi mode only (not in this port yet).")
    args = _parse_args_or_exit(parser, argv)
    if args.binary_input or args.binary_outfile or args.symmetric != "auto":
        parser.error(f"-bi/-bo/--symmetric: the streamed correction comes with "
                     f"{STREAM_ADJ_SLICE}")

    from seekr_tpu_torch.io.fast_csv import read_labeled_csv
    from seekr_tpu_torch.stats.adj_pval import adj_pval

    _device(args)  # the correction runs on the host; the device rule holds
    adj_pval(read_labeled_csv(args.pval_path), args.method, float(args.alpha),
             args.outputname)


# -- module dispatcher (python -m seekr_tpu_torch.cli <command> ...) -----------

COMMANDS = {
    "kmer_counts": console_kmer_counts,
    "norm_vectors": console_norm_vectors,
    "pearson": console_pearson,
    "find_dist": console_find_dist,
    "find_pval": console_find_pval,
    "adj_pval": console_adj_pval,
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m seekr_tpu_torch.cli <command> [args...]\n")
        print("commands:", ", ".join(COMMANDS))
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command: {cmd}")
        print("commands:", ", ".join(COMMANDS))
        return 2
    COMMANDS[cmd](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
