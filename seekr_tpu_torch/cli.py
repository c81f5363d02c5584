"""The port's command line: ``python -m seekr_tpu_torch.cli <command> [args]``.

The 26 commands of ``seekr_tpu/cli.py``, with its flags and defaults and the
same file contracts (counts CSV/npy, mean/std npy, pearson npy/csv, fitres CSV,
p-value CSV and npy, corpus snapshot npz, query CSV, Gephi nodes/edges CSVs,
workflow artifacts, domain r-values and percentiles, PWM scores, fastas, GML
and node->Group CSV, figures):

  main path    kmer_counts, norm_vectors, pearson
  statistics   find_dist (-pf: the fit plot), find_pval, adj_pval (-bi: the
               streamed correction)
  workflow     pipeline
  models       domain_pearson, pwms
  communities  kmer_leiden (-pn: the network plot), graph
  plots        kmer_heatmap, kmer_dendrogram, kmer_count_barplot,
               kmer_msd_barplot, kmer_comp_textplot, kmer_indi_textplot,
               visualize_distro
  serving      serve, query
  data         canonical_gencode, filter_gencode, gen_rand_rnas, download_gencode
  health       doctor, help (every command's flag table)

One flag is the port's own: ``--device`` (default: the first CUDA card; ``cpu``
runs on the CPU).  Every command but the client ``query``, ``doctor`` and
``help`` resolves it first, so without a card and without ``--device cpu`` a
command raises instead of moving to the CPU on its own; the host-only commands
(adj_pval, pwms, graph, the textplots, visualize_distro, the data tools) hold
the same rule.  ``doctor`` probes the card ``--device`` names in a subprocess.
The plots and ``graph`` need matplotlib, seaborn and networkx, which are
imported only when a command draws.  ``-dp``/``-kp`` build a device mesh in
this process, of CUDA cards or, with ``--device cpu``, of CPU shards
(``parallel.mesh``); the multi-host flags (``--coordinator``,
``--num_processes``, ``--process_id``) come with the port's slice 9 and are
refused with an error that names it.  A bare command prints its help; a bare
``doctor`` runs.
"""

from __future__ import annotations

import argparse
import csv
import sys

LOG2_CHOICES = ["Log2.post", "Log2.pre", "Log2.none"]
DEVICE_HELP = ("where counting and Pearson run: a torch device such as 'cuda:0' "
               "or 'cpu' (default: the first CUDA card)")

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

  $ python -m seekr_tpu_torch.cli find_dist background.fa -k 4 -fm -o fitres -pf fits
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

A .npy input (-bi, from find_pval -bo) is corrected with bounded memory: the
matrix stays on disk, values are bucket-sorted through scratch files, and the
result is bitwise the in-memory path's (every method but hommel).  --symmetric
yes/no skips the 5-decimal transpose detection (a full extra read):

  $ python -m seekr_tpu_torch.cli adj_pval pvals.npy fdr_bh -bi -o adj_pvals -bo adj.npy
  $ python -m seekr_tpu_torch.cli adj_pval pvals.npy fdr_bh -bi --symmetric yes -o adj_pvals
"""

KMER_LEIDEN_DOC = """
Leiden community detection over fasta sequences: counts (normalized by the
given mean/std vectors) and self-Pearson on the card, edges kept above
-pco pearsoncutoff, then the Leiden algorithm (the host C++ engine; six
partition types), a spring-layout network plot (-pn, a pdf) and Gephi-ready
nodes/edges CSVs (-cf).

  $ python -m seekr_tpu_torch.cli kmer_leiden rnas.fa mean_4.npy std_4.npy 4 -pn net -cf net
  $ python -m seekr_tpu_torch.cli kmer_leiden rnas.fa mean_4.npy std_4.npy 4 -a CPMVertexPartition -r 1.5 -sd -pco 0.1 -cf net
"""

SERVE_DOC = """
Warm-resident similarity service over a UNIX socket.  Loads the norm vectors,
the target fasta (or a .npz snapshot) and a find_dist fitres ONCE, keeps the
standardized targets on the card, and answers newline-delimited JSON requests:

  request : {"seqs": ["AGTC...", ...], "want": ["sim", "pvals"]}
  response: {"ok": true, "sim": [[...]], "pvals": [[...]], "m": Q, "n": T}
  top-k   : {"seqs": [...], "want": ["topk"], "topk": 10} returns the 10 nearest
            targets per query (topk_sim / topk_idx / topk_names, + topk_pvals
            via want=["topk_pvals"]), selected on the card
  ops     : {"op": "ping"}, {"op": "add_targets", "seqs"/"fasta": ...},
            {"op": "save_corpus", "path": "c.npz"}, {"op": "shutdown"}

The socket is created owner-only (0600).  Client-directed disk writes are
rejected unless --allow-artifacts DIR is given, and are then confined to DIR.

  $ python -m seekr_tpu_torch.cli serve mean.npy std.npy -k 6 -t gencode.fa \\
        -fr fitres.csv --socket seekr.sock
"""

QUERY_DOC = """
Query a running service: reads the query fasta, sends one request over the
socket and writes CSV, the bytes seekr_tpu's query command writes.  The client
needs no card and imports no torch.  Default output is the full [Q, T]
similarity matrix labeled by query and target headers; --topk N gives the N
nearest targets per query as tidy rows (query, rank, target, r).

  $ python -m seekr_tpu_torch.cli query queries.fa --socket seekr.sock -o sim.csv
  $ python -m seekr_tpu_torch.cli query queries.fa --socket seekr.sock --topk 10 --pvals
"""


PIPELINE_DOC = """
One-shot analysis: background norm vectors and empirical null, query counts,
all-pairs Pearson, empirical p-values and multiple-test correction, in memory,
artifacts written once (mean/std .npy, counts1/2.csv, pearson.csv, pvals.csv,
pvals_adjusted.csv).  The chain norm_vectors -> kmer_counts -> pearson ->
find_dist -> find_pval -> adj_pval; --leiden appends communities on the
self-similarity graph (communities.csv).

  $ python -m seekr_tpu_torch.cli pipeline queries.fa -b gencode_lncRNA.fa -k 6 -o results/
  $ python -m seekr_tpu_torch.cli pipeline rnas.fa -b bkg.fa --leiden -lc 0.1 -o results/
"""

DOMAIN_PEARSON_DOC = """
Sliding-window domain Pearson: correlate whole-query k-mer profiles against
windows tiled across target sequences; r peaks mark query-like domains.  With a
reference fasta, each r also gets a percentile within that query's
r-distribution against the reference.

  $ python -m seekr_tpu_torch.cli domain_pearson queries.fa targets.fa -r gencode.fa \\
        -rp r_values.csv -pp percentiles.csv -w 1000 -sl 100 -k 6
"""

PWMS_DOC = """
Weight k-mer count profiles by protein-binding motif PWMs: each sequence is
scored against every position-weight-matrix file in a directory; a score is the
PWM-alignment weight vector dotted with the sequence's k-mer counts.

  $ python -m seekr_tpu_torch.cli pwms pwms/ counts.npy -k 5 -o pwm_scores.csv
"""

CANONICAL_GENCODE_DOC = """
Keep only '-001'-named transcripts of an old-style GENCODE fasta.  Current
releases dropped -001 numbering; use filter_gencode with a GTF instead.

  $ python -m seekr_tpu_torch.cli canonical_gencode v22_lncRNAs.fa v22_canonical.fa -z 2
"""

FILTER_GENCODE_DOC = """
Filter a GENCODE-format fasta by any combination of: minimum sequence length
(-len, read from the header's length field), the Ensembl_canonical GTF tag
(-can, needs -gtf), transcript isoform number (-iso, regex allowed, '0'
disables), and exact-duplicate removal keeping the first occurrence (-rd).
Writes '{outputname}.fa'.

  $ python -m seekr_tpu_torch.cli filter_gencode v43_lncRNA.fa -gtf v43.gtf -len 500 -can -rd -o filtered
  $ python -m seekr_tpu_torch.cli filter_gencode v43_lncRNA.fa -gtf v43.gtf -iso 201 -o iso201
"""

GEN_RAND_RNAS_DOC = """
Random RNAs that keep the k-mer content of an input fasta: each sequence is
replaced by a k-mer-multiset-preserving Euler shuffle, optionally with point
mutations, optionally shuffling the pooled concatenation (-g).

  $ python -m seekr_tpu_torch.cli gen_rand_rnas rnas.fa rand_rnas.fa -k 2 -m 5 -s 0
"""

DOWNLOAD_GENCODE_DOC = """
Download a transcript fasta (and optionally the matching GTF) from GENCODE.
'biotype' is 'all', 'pc' (protein-coding) or 'lncRNA'.  Without -r the latest
release of the species is looked up; downloads are gunzipped unless -z is set.

  $ python -m seekr_tpu_torch.cli download_gencode lncRNA
  $ python -m seekr_tpu_torch.cli download_gencode lncRNA -s mouse -r M25 -z -g
"""

KMER_HEATMAP_DOC = """
Heatmap of an r- or p-value matrix with a two/three-color gradient pivoting at
'threshold' (hex colors accepted), optional hierarchical clustering of rows and
columns with inset dendrograms (-cl; above 2^33 flops the pdist runs on the
card), and a threshold tick on the colorbar.  The two positionals bound the
color scale (e.g. 0 1 for p-values, -1 1 for r-values).

  $ python -m seekr_tpu_torch.cli kmer_heatmap pvals.csv 0 1 -cl
  $ python -m seekr_tpu_torch.cli kmer_heatmap pearson.csv -1 1 -th 0.13 -hf png -hd 300
"""

KMER_DENDROGRAM_DOC = """
Dendrogram of the hierarchical clustering of a matrix's rows (-dd row) or
columns (-dd column), with configurable distance metric and linkage method: a
view of the clustering kmer_heatmap applies.

  $ python -m seekr_tpu_torch.cli kmer_dendrogram pearson.csv -dd row
  $ python -m seekr_tpu_torch.cli kmer_dendrogram pvals.csv -dd column -linkm ward -ph 10
"""

KMER_COUNT_BARPLOT_DOC = """
Grouped barplot comparing the normalized k-mer counts of up to 10 sequences,
showing the -tn k-mers whose counts deviate most from the column mean (summed
|difference|, ascending or descending).  The counting runs on the card.

  $ python -m seekr_tpu_torch.cli kmer_count_barplot rnas.fa mean_4.npy std_4.npy 4 -o barplot
  $ python -m seekr_tpu_torch.cli kmer_count_barplot rnas.fa mean_4.npy std_4.npy 4 -tn 20 -sm descending -pf png
"""

KMER_MSD_BARPLOT_DOC = """
Barplot of each k-mer's mean count +/- standard deviation across all sequences
of a fasta, ordered by mean or sd, limited to the -tn most extreme k-mers.  The
counting runs on the card.

  $ python -m seekr_tpu_torch.cli kmer_msd_barplot rnas.fa mean_4.npy std_4.npy 4 -o msd
  $ python -m seekr_tpu_torch.cli kmer_msd_barplot rnas.fa mean_4.npy std_4.npy 4 -tn 15 -ss sd
"""

KMER_COMP_TEXTPLOT_DOC = """
Render two sequences character by character (wrapped at -wl columns) with up to
10 motif words highlighted in color; overlapping motifs take the first word's
color.

  $ python -m seekr_tpu_torch.cli kmer_comp_textplot a.fa b.fa 'ATTA,AAAA' -o comp
  $ python -m seekr_tpu_torch.cli kmer_comp_textplot a.fa b.fa 'GGGG' -wl 80 -cv '#d62728'
"""

KMER_INDI_TEXTPLOT_DOC = """
The character-grid rendering of kmer_comp_textplot, one plot per sequence of
the input fasta, saved into -op; each plot is named by the header up to the
first '|'.

  $ python -m seekr_tpu_torch.cli kmer_indi_textplot rnas.fa 'ATTA,AAAA' -op plots/
"""

GRAPH_DOC = """
Community graph from an adjacency matrix (legacy seekr 1.x capability): threshold
the matrix, build the weighted graph, partition its largest connected component
(the host C++ Leiden engine), and write a Group-annotated GML plus a
node-to-community CSV.

  $ python -m seekr_tpu_torch.cli graph adj.npy -g graph.gml -c communities.csv -t 0.13
"""

VISUALIZE_DISTRO_DOC = """
Histogram of a similarity matrix's r-value distribution (legacy seekr 1.x
capability): the strict upper triangle of a symmetric matrix, every finite value
otherwise, summary statistics in the title.  A large .npy is read in bounded
memory.

  $ python -m seekr_tpu_torch.cli visualize_distro pearson.npy -o distro -b 100
"""

DOCTOR_DOC = """
Environment health report: python, torch (and its CUDA), numpy and scipy; the
card's name and power limit; the nvcc build of the kernels and one launch of
count_kmers_smem against its plain version, in a subprocess under a timeout;
the g++ build of the host library; the SEEKR_TPU_* variables that are set.
Exit code 0 when no check fails, 1 otherwise.

  $ python -m seekr_tpu_torch.cli doctor
  $ python -m seekr_tpu_torch.cli doctor --no-device          # host-only checks
"""


class _CollectParser(Exception):
    """Carrier for parser harvesting (see ``_collect_parser``)."""

    def __init__(self, parser):
        self.parser = parser


_COLLECT = object()  # sentinel argv: harvest the parser instead of parsing


def _parse_args_or_exit(parser, argv=None):
    if argv is _COLLECT:
        raise _CollectParser(parser)
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        parser.print_help()
        sys.exit(0)
    return parser.parse_args(argv)


def _collect_parser(console_fn) -> argparse.ArgumentParser:
    """A command's fully built parser, without running the command.

    Every command funnels through ``_parse_args_or_exit``, so the ``_COLLECT``
    sentinel as argv stops it at the parse with its parser in hand: ``help``
    prints the real parsers, with no second copy of any flag.
    """
    try:
        console_fn(argv=_COLLECT)
    except _CollectParser as collected:
        return collected.parser
    raise RuntimeError("command did not route through _parse_args_or_exit")


def _parser(doc) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        usage=doc, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--device", default=None, help=DEVICE_HELP)
    return parser


def _device(args):
    from seekr_tpu_torch.utils.device import resolve_device

    return resolve_device(args.device)


def _refuse_multi_host(parser, args):
    """Refuse the multi-host bootstrap flags: a coordinator, a process id, or
    more than one process."""
    from seekr_tpu_torch.parallel.mesh import MULTI_HOST

    for flag in ("coordinator", "num_processes", "process_id"):
        value = getattr(args, flag)
        if value is None or (flag == "num_processes" and value <= 1):
            continue
        parser.error(f"--{flag} {value}: {MULTI_HOST}")


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
        # float32, as seekr_tpu's native reader gives them (the GEMM's type)
        labeled1 = read_labeled_csv(counts1, dtype=np.float32)
        labeled2 = read_labeled_csv(counts2, dtype=np.float32)
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
                        help="path to save the fit grid plot (pdf appended).")
    parser.add_argument("-o", "--outputname", default=None,
                        help="path to save results csv (csv appended).")
    parser.add_argument("-nj", "--n_jobs", default=1,
                        help="host processes for distribution fitting.")
    # -fto, not -ft: find_pval binds -ft to --fitres_type
    parser.add_argument("-fto", "--fit_timeout", default=None, type=float,
                        help="per-distribution fit timeout in seconds; a "
                             "timed-out fit is skipped like any failed fit.")
    parser.add_argument("-dp", "--data_parallel", default=None, type=int,
                        help="devices on the mesh 'data' axis for the O(m^2) "
                             "background Pearson.")
    parser.add_argument("-kp", "--kmer_parallel", default=1, type=int,
                        help="devices on the mesh 'kmer' axis.")
    args = _parse_args_or_exit(parser, argv)

    from seekr_tpu_torch.stats.find_dist import find_dist

    device = _device(args)
    models = args.models if args.models in ("common10", "all") else args.models.split(",")
    find_dist(args.fasta, int(args.kmer), args.log2, models,
              args.subsetting, int(args.subset_size), args.fit_model,
              args.statsmethod, args.progress_bar, args.plotfit, args.outputname,
              n_jobs=int(args.n_jobs), fit_timeout=args.fit_timeout,
              data_parallel=args.data_parallel, kmer_parallel=args.kmer_parallel,
              device=device)


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
                        help="devices on the mesh 'data' axis for the O(m1*m2) "
                             "Pearson (combines with --stream).")
    args = _parse_args_or_exit(parser, argv)

    from seekr_tpu_torch.stats.find_pval import find_pval

    device = _device(args)
    fitres = parse_fitres_csv(args.fitres_file, args.fitres_type)
    stream = {None: None, "auto": None, "on": True, "off": False}[args.stream]
    find_pval(args.seq1file, args.seq2file, args.mean_path, args.std_path,
              int(args.kmer), fitres, args.log2, int(args.bestfit),
              args.outputname, args.progress_bar, stream=stream,
              npy_out=args.binary_outfile, data_parallel=args.data_parallel,
              device=device)


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
                        help="pval_path is a .npy artifact (find_pval -bo); the "
                             "correction then streams with bounded memory.")
    parser.add_argument("-bo", "--binary_outfile", default=None,
                        help="also write the corrected float64 matrix as .npy "
                             "(-bi mode only).")
    parser.add_argument("--symmetric", default="auto", choices=["auto", "yes", "no"],
                        help="-bi mode only: force the upper-triangle (yes) or "
                             "full-matrix (no) correction instead of the 5-decimal "
                             "transpose detection, which reads the artifact once "
                             "more.")
    args = _parse_args_or_exit(parser, argv)
    _device(args)  # the correction runs on the host; the device rule holds

    if args.binary_input:
        from seekr_tpu_torch.stats.stream_adj import adj_pval_stream

        adj_pval_stream(args.pval_path, args.method, float(args.alpha),
                        outputname=args.outputname, out_npy=args.binary_outfile,
                        symmetric={"auto": None, "yes": True, "no": False}[args.symmetric])
        return
    if args.binary_outfile:
        parser.error("-bo requires -bi (the streamed binary path)")
    if args.symmetric != "auto":
        parser.error("--symmetric requires -bi (the in-memory path keeps the "
                     "reference's auto-detection contract)")

    from seekr_tpu_torch.io.fast_csv import read_labeled_csv
    from seekr_tpu_torch.stats.adj_pval import adj_pval

    adj_pval(read_labeled_csv(args.pval_path), args.method, float(args.alpha),
             args.outputname)


# -- kmer_leiden -------------------------------------------------------------

def console_kmer_leiden(argv=None):
    from seekr_tpu_torch import native

    parser = _parser(KMER_LEIDEN_DOC)
    parser.add_argument("fasta", help="fasta file with unique headers.")
    parser.add_argument("mean_path", help="normalization mean vector (.npy).")
    parser.add_argument("std_path", help="normalization std vector (.npy).")
    parser.add_argument("kmer", help="k-mer length (must match the vectors).")
    parser.add_argument("-a", "--algo", default="RBERVertexPartition",
                        choices=list(native.ALGORITHMS),
                        help="Leiden partition quality function.")
    parser.add_argument("-r", "--rs", default=1.0, help="resolution parameter.")
    parser.add_argument("-pco", "--pearsoncutoff", default=0.0,
                        help="zero out r values below this cutoff.")
    parser.add_argument("-sd", "--setseed", action="store_true",
                        help="set seed for reproducible communities.")
    parser.add_argument("-ec", "--edgecolormethod", default="gradient",
                        choices=["gradient", "threshold"], help="edge coloring method.")
    parser.add_argument("-et", "--edgethreshold", default=0.1,
                        help="threshold for -ec threshold.")
    parser.add_argument("-lfs", "--labelfontsize", default=12,
                        help="node label font size.")
    parser.add_argument("-pn", "--plotname", default=None,
                        help="plot output path (pdf appended).")
    parser.add_argument("-cf", "--csvfile", default=None,
                        help="Gephi nodes/edges csv prefix.")
    parser.add_argument("--stream", default=None, choices=["auto", "on", "off"],
                        help="extract the thresholded edge set tile by tile instead "
                             "of holding the [m, m] similarity matrix ('auto' streams "
                             "above ~2.5B cells, m~50k; the Gephi edges file then "
                             "holds the detected edges).")
    parser.add_argument("-dp", "--data_parallel", default=None, type=int,
                        help="devices on the mesh 'data' axis for the O(m^2) "
                             "similarity GEMM (implies the streamed edge "
                             "extraction).")
    args = _parse_args_or_exit(parser, argv)

    from seekr_tpu_torch.graph import kmer_leiden

    stream = {None: None, "auto": None, "on": True, "off": False}[args.stream]
    kmer_leiden(args.fasta, args.mean_path, args.std_path, int(args.kmer), args.algo,
                float(args.rs), float(args.pearsoncutoff), args.setseed,
                args.edgecolormethod, float(args.edgethreshold), int(args.labelfontsize),
                args.plotname, args.csvfile, stream=stream,
                data_parallel=args.data_parallel, device=_device(args))


# -- serve / query -----------------------------------------------------------

def console_serve(argv=None):
    parser = _parser(SERVE_DOC)
    parser.add_argument("mean_path", help="normalization mean vector (.npy).")
    parser.add_argument("std_path", help="normalization std vector (.npy).")
    parser.add_argument("-k", "--kmer", default=6,
                        help="length of kmers you want to count.")
    parser.add_argument("-l", "--log2", default="Log2.post", choices=LOG2_CHOICES,
                        help="log2 transform mode.")
    parser.add_argument("-t", "--targets", default=None,
                        help="target fasta (default: score against the query "
                             "batch itself), or a .npz corpus snapshot written "
                             "by --save-corpus, which skips counting the fasta.")
    parser.add_argument("--save-corpus", default=None, dest="save_corpus",
                        help="write the loaded target corpus as a restartable "
                             ".npz snapshot and exit.")
    parser.add_argument("-fr", "--fitres_file", default=None,
                        help="find_dist fitres csv enabling 'pvals'.")
    parser.add_argument("-ft", "--fitres_type", default="distribution",
                        choices=["distribution", "npy"],
                        help="fitres artifact kind (see find_pval).")
    parser.add_argument("--socket", default="seekr_tpu.sock",
                        help="UNIX socket path to listen on (created owner-only, "
                             "mode 0600).")
    parser.add_argument("--allow-artifacts", default=None, dest="allow_artifacts",
                        metavar="DIR",
                        help="permit client-directed disk writes (query 'outfile' "
                             "prefixes and the save_corpus op), confined to DIR.")
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip the warmup passes.")
    parser.add_argument("--mem-budget", default=None, type=int, dest="mem_budget",
                        metavar="BYTES",
                        help="resident-corpus device-memory budget in bytes; "
                             "add_targets past it is refused.  Default: half the "
                             "card's memory (SEEKR_TPU_CORPUS_BUDGET also sets it).")
    parser.add_argument("--grow-quantum", default=256, type=int, dest="grow_quantum",
                        metavar="ROWS",
                        help="the resident corpus is padded to a multiple of this "
                             "many rows, so a small add_targets changes no shape; "
                             "1 disables.")
    parser.add_argument("--no-coalesce", action="store_true",
                        help="serve each request as its own device batch.")
    parser.add_argument("-dp", "--data_parallel", default=None, type=int,
                        help="shard the target corpus over this many devices "
                             "(needs -t/--targets).")
    parser.add_argument("--coordinator", default=None,
                        help="multi-host bootstrap address (the port's slice 9).")
    parser.add_argument("--num_processes", default=None, type=int,
                        help="multi-host process count (the port's slice 9).")
    parser.add_argument("--process_id", default=None, type=int,
                        help="multi-host process id (the port's slice 9).")
    args = _parse_args_or_exit(parser, argv)
    _refuse_multi_host(parser, args)
    if (args.data_parallel or 0) > 1 and not args.targets:
        parser.error("-dp requires -t/--targets: the sharded corpus "
                     "is the thing being distributed")
    if args.save_corpus and not args.targets:
        parser.error("--save-corpus requires -t/--targets: the snapshot "
                     "is the loaded target corpus")

    from seekr_tpu_torch.parallel.mesh import build_mesh_from_flags
    from seekr_tpu_torch.serve import SeekrService, serve_forever

    device = _device(args)
    mesh = build_mesh_from_flags(args.data_parallel, device=device)
    fitres = None
    if args.fitres_file:
        fitres = parse_fitres_csv(args.fitres_file, args.fitres_type)
    svc = SeekrService(args.mean_path, args.std_path, k=int(args.kmer),
                       log2=args.log2, targets=args.targets, fitres=fitres,
                       coalesce=not args.no_coalesce, mesh=mesh,
                       mem_budget_bytes=args.mem_budget,
                       grow_quantum=args.grow_quantum, device=device)
    if args.save_corpus:
        svc.save_corpus(args.save_corpus)
        print(f"seekr_tpu_torch serve: corpus snapshot written to "
              f"{args.save_corpus} (serve with -t {args.save_corpus})", flush=True)
        return
    if not args.no_warmup:
        print("seekr_tpu_torch serve: warming up...", flush=True)
        svc.warmup()
    print(f"seekr_tpu_torch serve: listening on {args.socket}", flush=True)
    serve_forever(svc, args.socket, artifact_dir=args.allow_artifacts)


def _topk_csv(names, targets, sims, pvals=None) -> bytes:
    """The tidy top-k rows (query, rank, target, r[, pval]) as the bytes of
    seekr_tpu's ``pd.DataFrame(rows).to_csv(index=False)``."""
    import numpy as np

    from seekr_tpu_torch.io.fast_csv import _quote, _shortest_cells

    def floats(rows):
        return _shortest_cells(np.asarray([v for row in rows for v in row],
                                          dtype=np.float64)).astype(str)

    r = floats(sims)
    p = floats(pvals) if pvals is not None else None
    lines = ["query,rank,target,r" + (",pval" if p is not None else "")]
    i = 0
    for qi, trow in enumerate(targets):
        for rank, t in enumerate(trow):
            line = f"{_quote(names[qi])},{rank},{_quote(t)},{r[i]}"
            lines.append(line + (f",{p[i]}" if p is not None else ""))
            i += 1
    return ("\n".join(lines) + "\n").encode()


def _emit(dest, data: bytes) -> None:
    """Write CSV bytes to ``dest``, or to standard output when it is None."""
    if dest:
        with open(dest, "wb") as fh:
            fh.write(data)
    else:
        sys.stdout.write(data.decode())
        sys.stdout.flush()


def console_query(argv=None):
    parser = argparse.ArgumentParser(usage=QUERY_DOC,
                                     formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("query_fasta", help="fasta file with the query sequences.")
    parser.add_argument("--socket", default="seekr_tpu.sock",
                        help="UNIX socket path of the running service.")
    parser.add_argument("-o", "--outfile", default=None,
                        help="write the CSV here (default: stdout).")
    parser.add_argument("--pvals", action="store_true",
                        help="also request p-values (the service needs a fitres).")
    parser.add_argument("--topk", default=0, type=int,
                        help="return the N nearest targets per query instead of "
                             "the full matrix.")
    parser.add_argument("--npy", default=None,
                        help="server-side artifact mode: the SERVICE writes "
                             "<prefix>_sim.npy / <prefix>_pvals.npy.")
    parser.add_argument("--timeout", default=600.0, type=float,
                        help="socket timeout in seconds.")
    args = _parse_args_or_exit(parser, argv)

    import os

    import numpy as np

    from seekr_tpu_torch.io.fast_csv import labeled_csv_bytes
    from seekr_tpu_torch.io.fasta import Reader
    from seekr_tpu_torch.serve import request

    reader = Reader(args.query_fasta)
    seqs = reader.get_seqs()
    names = [h[1:] for h in reader.get_headers()]
    if args.topk:
        want = ["topk", "topk_pvals"] if args.pvals else ["topk"]
    else:
        want = ["sim", "pvals"] if args.pvals else ["sim"]
    payload = {"seqs": seqs, "want": want, "names": not args.topk}
    if args.topk:
        payload["topk"] = args.topk
    if args.npy:
        payload["outfile"] = args.npy
    resp = request(args.socket, payload, timeout=args.timeout)
    if not resp.get("ok"):
        print(f"seekr_tpu_torch query: service error: {resp.get('error')}",
              file=sys.stderr)
        sys.exit(1)

    if args.topk:
        _emit(args.outfile, _topk_csv(names, resp.get("topk_names") or resp["topk_idx"],
                                      resp["topk_sim"], resp.get("topk_pvals")))
        return
    if args.npy:
        for key, path in resp.get("files", {}).items():
            print(f"{key}: {path}")
        return
    cols = resp.get("target_names", names)
    for key in ("sim", "pvals"):
        if key in resp:
            dest = args.outfile
            if dest and "pvals" in resp and "sim" in resp:
                root, ext = os.path.splitext(dest)
                dest = f"{root}_{key}{ext or '.csv'}"
            _emit(dest, labeled_csv_bytes(np.asarray(resp[key], dtype=np.float64),
                                          names, cols))


# -- pipeline ----------------------------------------------------------------

def console_pipeline(argv=None):
    parser = _parser(PIPELINE_DOC)
    parser.add_argument("seq1file", help="query fasta (rows of the output).")
    parser.add_argument("-s2", "--seq2file", default=None,
                        help="second fasta (columns); default: seq1file.")
    parser.add_argument("-b", "--background", required=True,
                        help="background fasta for norm vectors + null.")
    parser.add_argument("-k", "--kmer", default=6, help="k-mer length.")
    parser.add_argument("-l", "--log2", default="Log2.post", choices=LOG2_CHOICES,
                        help="log2 transform mode.")
    parser.add_argument("-m", "--method", default="fdr_bh",
                        help="multiple-comparison correction method.")
    parser.add_argument("-a", "--alpha", default=0.05, help="family-wise error rate.")
    parser.add_argument("-sbs", "--subset_size", default=100000,
                        help="max null-sample size.")
    parser.add_argument("-sd", "--seed", default=None, help="seed for null subsampling.")
    parser.add_argument("-o", "--outdir", default="seekr_out",
                        help="artifact output directory.")
    parser.add_argument("--leiden", action="store_true",
                        help="append Leiden community detection on the query "
                             "self-similarity graph (native engine); writes "
                             "communities.csv.")
    parser.add_argument("-lc", "--leiden_cutoff", default=0.0,
                        help="edge threshold: r below this becomes 0 "
                             "(kmer_leiden pearsoncutoff semantics).")
    parser.add_argument("-la", "--leiden_algo", default="RBERVertexPartition",
                        help="leidenalg partition algorithm name.")
    parser.add_argument("-lr", "--leiden_resolution", default=1.0,
                        help="resolution for RBConfig/RBER/CPM partitions.")
    parser.add_argument("-dp", "--data_parallel", default=None, type=int,
                        help="devices on the mesh 'data' axis; >1 routes the "
                             "O(m^2) Pearson stages through the data-sharded "
                             "streaming GEMM.")
    parser.add_argument("-kp", "--kmer_parallel", default=1, type=int,
                        help="devices on the mesh 'kmer' axis.")
    parser.add_argument("--coordinator", default=None,
                        help="multi-host bootstrap address (the port's slice 9).")
    parser.add_argument("--num_processes", default=None, type=int,
                        help="multi-host process count (the port's slice 9).")
    parser.add_argument("--process_id", default=None, type=int,
                        help="multi-host process id (the port's slice 9).")
    args = _parse_args_or_exit(parser, argv)
    _refuse_multi_host(parser, args)

    from seekr_tpu_torch.models.workflow import run_workflow
    from seekr_tpu_torch.utils.profiler import trace_session

    device = _device(args)
    with trace_session():  # a trace of the whole run when SEEKR_TPU_TRACE is set
        run_workflow(args.seq1file, args.seq2file, args.background, k=int(args.kmer),
                     log2=args.log2, adj_method=args.method, alpha=float(args.alpha),
                     outdir=args.outdir, subset_size=int(args.subset_size),
                     seed=None if args.seed is None else int(args.seed),
                     leiden=args.leiden, leiden_cutoff=float(args.leiden_cutoff),
                     leiden_algo=args.leiden_algo,
                     leiden_resolution=float(args.leiden_resolution),
                     data_parallel=args.data_parallel, kmer_parallel=args.kmer_parallel,
                     device=device)


# -- domain_pearson ----------------------------------------------------------

def console_domain_pearson(argv=None):
    parser = _parser(DOMAIN_PEARSON_DOC)
    parser.add_argument("query", help="Fasta of query transcripts (profiled whole).")
    parser.add_argument("target", help="Fasta of target sequences (tiled into windows).")
    parser.add_argument("-r", "--reference", default=None,
                        help="Fasta providing the percentile null distribution "
                             "(optional).")
    parser.add_argument("-rp", "--r_values_path", default="r_values.csv",
                        help="CSV path for the window x query r-values.")
    parser.add_argument("-pp", "--percentiles_path", default=None,
                        help="CSV path for the window x query percentiles "
                             "(needs --reference).")
    parser.add_argument("-m", "--mean", default=None,
                        help="Path to a .npy mean vector (default: computed from "
                             "the reference fasta, else the windows).")
    parser.add_argument("-s", "--std", default=None,
                        help="Path to a .npy std vector (same default rule).")
    parser.add_argument("-l", "--log2", default="Log2.post", choices=LOG2_CHOICES,
                        help="Log2 transform mode.")
    parser.add_argument("-k", "--kmer", default=6, help="Length of kmers to profile.")
    parser.add_argument("-w", "--window", default=1000, help="Window width in bases.")
    parser.add_argument("-sl", "--slide", default=100, help="Window stride in bases.")
    args = _parse_args_or_exit(parser, argv)

    from seekr_tpu_torch.models.domain import DomainPearson

    DomainPearson(query_path=args.query, target_path=args.target,
                  reference_path=args.reference, r_values_path=args.r_values_path,
                  percentiles_path=args.percentiles_path,
                  mean=args.mean if args.mean is not None else True,
                  std=args.std if args.std is not None else True,
                  log2=args.log2, k=int(args.kmer), window=int(args.window),
                  slide=int(args.slide), device=_device(args)).run()


# -- pwms --------------------------------------------------------------------

def console_pwms(argv=None):
    parser = _parser(PWMS_DOC)
    parser.add_argument("pwm_dir", help="Directory of tab-separated PWM files "
                                        "(Pos/A/C/G/U columns).")
    parser.add_argument("counts", help="k-mer counts artifact (.npy or labeled CSV) "
                                       "to score.")
    parser.add_argument("-k", "--kmer", default=5,
                        help="Length of kmers the counts were made with.")
    parser.add_argument("-o", "--out_path", default=None,
                        help="CSV path for the PWM x sequence score table.")
    args = _parse_args_or_exit(parser, argv)
    _device(args)  # scoring runs on the host; the device rule holds

    from seekr_tpu_torch.models.pwm import CountsWeighter

    CountsWeighter(args.pwm_dir, args.counts, k=int(args.kmer), out_path=args.out_path).run()


# -- data tools --------------------------------------------------------------

def console_canonical_gencode(argv=None):
    parser = _parser(CANONICAL_GENCODE_DOC)
    parser.add_argument("in_fasta", help="Old-style GENCODE fasta to filter.")
    parser.add_argument("out_fasta", help="Path for the filtered fasta.")
    parser.add_argument("-z", "--zeros", default=2,
                        help="Zeros in the kept suffix (2 -> '-001').")
    args = _parse_args_or_exit(parser, argv)
    _device(args)

    from seekr_tpu_torch.data.canonical import canonical_gencode

    canonical_gencode(args.in_fasta, args.out_fasta, zeros=int(args.zeros))


def console_filter_gencode(argv=None):
    parser = _parser(FILTER_GENCODE_DOC)
    parser.add_argument("fasta", help="Fasta file to filter (GENCODE format).")
    parser.add_argument("-gtf", "--gtf_path", default=None,
                        help="Matching gtf (needed for -can / -iso).")
    parser.add_argument("-len", "--len_threshold", default=0,
                        help="Keep sequences with length >= threshold.")
    parser.add_argument("-can", "--canonical", action="store_true",
                        help="Keep only Ensembl_canonical transcripts.")
    parser.add_argument("-iso", "--isoform", default="0",
                        help="Isoform number filter (regex allowed); '0' disables.")
    parser.add_argument("-rd", "--rmdup", action="store_true",
                        help="Remove exact-duplicate sequences (keep first).")
    parser.add_argument("-o", "--outputname", default="test",
                        help="Output name; '.fa' appended automatically.")
    args = _parse_args_or_exit(parser, argv)
    _device(args)

    from seekr_tpu_torch.data.filter_gencode import filter_gencode

    filter_gencode(args.fasta, args.gtf_path, int(args.len_threshold), args.canonical,
                   args.isoform, args.rmdup, args.outputname)


def console_gen_rand_rnas(argv=None):
    parser = _parser(GEN_RAND_RNAS_DOC)
    parser.add_argument("infasta", help="Full path of fasta file to shuffle.")
    parser.add_argument("outfasta", help="Path for the shuffled fasta.")
    parser.add_argument("-k", "--kmer", default=1,
                        help="Size of the preserved kmers (1 = composition only).")
    parser.add_argument("-m", "--mutations", default=0,
                        help="Number of point mutations per sequence.")
    parser.add_argument("-s", "--seed", default=None,
                        help="RNG seed for reproducible output.")
    parser.add_argument("-g", "--group", action="store_true",
                        help="Shuffle the pooled concatenation of all sequences "
                             "instead of each individually.")
    args = _parse_args_or_exit(parser, argv)
    _device(args)

    from seekr_tpu_torch.data.rand_rnas import gen_rand_rnas

    gen_rand_rnas(args.infasta, args.outfasta, k=int(args.kmer),
                  mutations=int(args.mutations),
                  seed=None if args.seed is None else int(args.seed), group=args.group)


def console_download_gencode(argv=None):
    parser = _parser(DOWNLOAD_GENCODE_DOC)
    parser.add_argument("biotype", help="GENCODE set: 'all', 'pc', or 'lncRNA'.")
    parser.add_argument("-s", "--species", default="human", help="'human' or 'mouse'.")
    parser.add_argument("-g", "--gtf", action="store_true",
                        help="Also download the comprehensive gtf file.")
    parser.add_argument("-r", "--release", default=None,
                        help="Specific release (e.g. 'M5'); latest if omitted.")
    parser.add_argument("-fp", "--fasta_path", default=None,
                        help="Output path for the fasta (.gz).")
    parser.add_argument("-gp", "--gtf_path", default=None,
                        help="Output path for the gtf (.gz).")
    parser.add_argument("-z", "--zip", action="store_false",
                        help="Set to keep the downloaded files gzipped.")
    args = _parse_args_or_exit(parser, argv)
    _device(args)

    from seekr_tpu_torch.data.gencode import Downloader

    Downloader().get_gencode(args.biotype, args.species, args.gtf, args.release,
                             args.fasta_path, args.gtf_path, args.zip)


# -- plots -------------------------------------------------------------------

def console_kmer_heatmap(argv=None):
    parser = _parser(KMER_HEATMAP_DOC)
    parser.add_argument("df_file", help="csv matrix with row/column names.")
    parser.add_argument("datamin", help="minimum possible data value.")
    parser.add_argument("datamax", help="maximum possible data value.")
    parser.add_argument("-th", "--thresh_value", default=0.05,
                        help="middle-color pivot for 3-color palettes.")
    parser.add_argument("-cr", "--color_range_str", default="#1b7837,#ffffff,#c51b7d",
                        help="comma-separated 2 or 3 hex colors.")
    parser.add_argument("-cl", "--cluster", action="store_true",
                        help="cluster and draw dendrograms on rows+columns.")
    parser.add_argument("-distm", "--distmetric", default="correlation",
                        help="distance metric for clustering.")
    parser.add_argument("-linkm", "--linkmethod", default="complete",
                        help="linkage method for clustering.")
    parser.add_argument("-wratio", "--hmapw_ratio", default=0.3,
                        help="heatmap width ratio factor.")
    parser.add_argument("-hratio", "--hmaph_ratio", default=0.3,
                        help="heatmap height ratio factor.")
    parser.add_argument("-xts", "--x_tick_size", default=16, help="column label font size.")
    parser.add_argument("-yts", "--y_tick_size", default=16, help="row label font size.")
    parser.add_argument("-cfs", "--cbar_font_size", default=16,
                        help="colorbar tick font size.")
    parser.add_argument("-o", "--outputname", default="test_kmer_heatmap",
                        help="output path/name.")
    parser.add_argument("-hf", "--hformat", default="pdf", help="output format.")
    parser.add_argument("-hd", "--hdpi", default=300, help="output dpi.")
    args = _parse_args_or_exit(parser, argv)
    device = _device(args)

    from seekr_tpu_torch.io.fast_csv import read_labeled_csv
    from seekr_tpu_torch.viz import kmer_heatmap

    kmer_heatmap(read_labeled_csv(args.df_file), int(args.datamin), int(args.datamax),
                 float(args.thresh_value), args.color_range_str.split(","),
                 args.cluster, args.distmetric, args.linkmethod,
                 float(args.hmapw_ratio), float(args.hmaph_ratio),
                 int(args.x_tick_size), int(args.y_tick_size),
                 int(args.cbar_font_size), args.outputname, args.hformat,
                 int(args.hdpi), device=device)


def console_kmer_dendrogram(argv=None):
    parser = _parser(KMER_DENDROGRAM_DOC)
    parser.add_argument("df_file", help="csv matrix with row/column names.")
    parser.add_argument("-dd", "--dendro_direct", default="row",
                        choices=["row", "column"], help="clustering direction.")
    parser.add_argument("-distm", "--distmetric", default="correlation",
                        help="distance metric.")
    parser.add_argument("-linkm", "--linkmethod", default="complete",
                        help="linkage method.")
    parser.add_argument("-ph", "--plot_ht", default=8, help="plot height.")
    parser.add_argument("-wratio", "--wd_ratio", default=0.5, help="width ratio factor.")
    parser.add_argument("-lfs", "--leaf_font_size", default=16,
                        help="leaf label font size.")
    parser.add_argument("-o", "--outputname", default="test_kmer_dendrogram",
                        help="output path/name.")
    parser.add_argument("-pf", "--pformat", default="pdf", help="output format.")
    parser.add_argument("-d", "--pdpi", default=300, help="output dpi.")
    args = _parse_args_or_exit(parser, argv)
    device = _device(args)

    from seekr_tpu_torch.io.fast_csv import read_labeled_csv
    from seekr_tpu_torch.viz import kmer_dendrogram

    kmer_dendrogram(read_labeled_csv(args.df_file), args.dendro_direct, args.distmetric,
                    args.linkmethod, int(args.plot_ht), float(args.wd_ratio),
                    int(args.leaf_font_size), args.outputname, args.pformat,
                    int(args.pdpi), device=device)


def _barplot_parser(doc, fasta_help, sort_flags):
    """The positionals, sort flags and figure flags the two barplots share."""
    parser = _parser(doc)
    parser.add_argument("fasta", help=fasta_help)
    parser.add_argument("mean_path", help="normalization mean vector (.npy).")
    parser.add_argument("std_path", help="normalization std vector (.npy).")
    parser.add_argument("kmer", help="k-mer length (must match the vectors).")
    parser.add_argument("-l", "--log2", default="Log2.post", choices=LOG2_CHOICES,
                        help="decided if and when to log transform counts")
    sort_flags(parser)
    parser.add_argument("-tn", "--topkmernumber", default=10,
                        help="number of k-mer words to plot.")
    parser.add_argument("-xls", "--xlabelsize", default=20, help="x axis label font size.")
    parser.add_argument("-yls", "--ylabelsize", default=20, help="y axis label font size.")
    parser.add_argument("-xts", "--xticksize", default=20, help="x tick label font size.")
    parser.add_argument("-yts", "--yticksize", default=20, help="y tick label font size.")
    return parser


def console_kmer_count_barplot(argv=None):
    def sort_flags(parser):
        parser.add_argument("-sm", "--sortmethod", default="ascending",
                            choices=["ascending", "descending"],
                            help="sort order of summed |diff from column mean|.")

    parser = _barplot_parser(KMER_COUNT_BARPLOT_DOC,
                             "fasta file (first 10 sequences used).", sort_flags)
    parser.add_argument("-ls", "--legendsize", default=12, help="legend font size.")
    parser.add_argument("-o", "--outputname", default="test_kmer_count_barplot",
                        help="output path/name.")
    parser.add_argument("-pf", "--pformat", default="pdf", help="output format.")
    parser.add_argument("-d", "--pdpi", default=300, help="output dpi.")
    args = _parse_args_or_exit(parser, argv)
    device = _device(args)

    from seekr_tpu_torch.viz import kmer_count_barplot

    kmer_count_barplot(args.fasta, args.mean_path, args.std_path, int(args.kmer),
                       args.log2, args.sortmethod, int(args.topkmernumber),
                       int(args.xlabelsize), int(args.ylabelsize), int(args.xticksize),
                       int(args.yticksize), int(args.legendsize), args.outputname,
                       args.pformat, int(args.pdpi), device=device)


def console_kmer_msd_barplot(argv=None):
    def sort_flags(parser):
        parser.add_argument("-ss", "--sortstat", default="mean", choices=["mean", "sd"],
                            help="sort statistic.")
        parser.add_argument("-sm", "--sortmethod", default="descending",
                            choices=["ascending", "descending"], help="sort order.")

    parser = _barplot_parser(KMER_MSD_BARPLOT_DOC, "fasta file with unique headers.",
                             sort_flags)
    parser.add_argument("-o", "--outputname", default="test_kmer_msd_barplot",
                        help="output path/name.")
    parser.add_argument("-pf", "--pformat", default="pdf", help="output format.")
    parser.add_argument("-d", "--pdpi", default=300, help="output dpi.")
    args = _parse_args_or_exit(parser, argv)
    device = _device(args)

    from seekr_tpu_torch.viz import kmer_msd_barplot

    kmer_msd_barplot(args.fasta, args.mean_path, args.std_path, int(args.kmer), args.log2,
                     args.sortstat, args.sortmethod, int(args.topkmernumber),
                     int(args.xlabelsize), int(args.ylabelsize), int(args.xticksize),
                     int(args.yticksize), args.outputname, args.pformat, int(args.pdpi),
                     device=device)


def _textplot_flags(parser, line_spacing_help):
    """The word, color and layout flags the two textplots share."""
    parser.add_argument("words_str",
                        help="comma-separated words, e.g. 'ATTA,AAAA,ACTC' (max 10).")
    parser.add_argument("-cv", "--color_vec_str", default="default",
                        help="comma-separated hex colors matching words, or 'default'.")
    parser.add_argument("-wl", "--wraplen", default=60, help="characters per line.")
    parser.add_argument("-cs", "--char_spacing", default=1.0,
                        help="space between characters.")
    parser.add_argument("-ls", "--line_spacing", default=0.5, help=line_spacing_help)
    parser.add_argument("-sfs", "--seqfontsize", default=28,
                        help="sequence character font size.")
    parser.add_argument("-nfs", "--numfontsize", default=18,
                        help="position number font size.")
    parser.add_argument("-cbh", "--colorblockh", default=0.5,
                        help="highlight block height.")


def _words_colors(args):
    words = args.words_str.split(",")
    colors = ("default" if args.color_vec_str == "default"
              else args.color_vec_str.split(","))
    return words, colors


def console_kmer_comp_textplot(argv=None):
    parser = _parser(KMER_COMP_TEXTPLOT_DOC)
    parser.add_argument("seq1file", help="first fasta (first sequence used).")
    parser.add_argument("seq2file", help="second fasta (first sequence used).")
    _textplot_flags(parser, "space between seq1, seq2 and ruler lines.")
    parser.add_argument("-o", "--outputname", default="comp_textplot",
                        help="output path/name.")
    parser.add_argument("-pf", "--plotformat", default="pdf", help="output format.")
    parser.add_argument("-d", "--plotdpi", default=300, help="output dpi.")
    args = _parse_args_or_exit(parser, argv)
    _device(args)

    from seekr_tpu_torch.viz import kmer_comp_textplot

    words, colors = _words_colors(args)
    kmer_comp_textplot(args.seq1file, args.seq2file, words, colors, int(args.wraplen),
                       float(args.char_spacing), float(args.line_spacing),
                       int(args.seqfontsize), int(args.numfontsize),
                       float(args.colorblockh), args.outputname, args.plotformat,
                       int(args.plotdpi))


def console_kmer_indi_textplot(argv=None):
    parser = _parser(KMER_INDI_TEXTPLOT_DOC)
    parser.add_argument("seqfile", help="input fasta file.")
    _textplot_flags(parser, "space between sequence and ruler lines.")
    parser.add_argument("-op", "--outputpath", default="",
                        help="output directory; plot names come from headers.")
    parser.add_argument("-pf", "--plotformat", default="pdf", help="output format.")
    parser.add_argument("-d", "--plotdpi", default=300, help="output dpi.")
    args = _parse_args_or_exit(parser, argv)
    _device(args)

    from seekr_tpu_torch.viz import kmer_indi_textplot

    words, colors = _words_colors(args)
    kmer_indi_textplot(args.seqfile, words, colors, int(args.wraplen),
                       float(args.char_spacing), float(args.line_spacing),
                       int(args.seqfontsize), int(args.numfontsize),
                       float(args.colorblockh), args.outputpath, args.plotformat,
                       int(args.plotdpi))


def console_visualize_distro(argv=None):
    parser = _parser(VISUALIZE_DISTRO_DOC)
    parser.add_argument("adj", help="Similarity matrix (.npy or labeled CSV), e.g. a "
                                    "pearson output.")
    parser.add_argument("-o", "--outputname", default="distro",
                        help="Output path without extension.")
    parser.add_argument("-b", "--bins", default=100, help="Histogram bin count.")
    parser.add_argument("-pf", "--pformat", default="pdf",
                        help="Figure format (matplotlib-supported).")
    parser.add_argument("-d", "--pdpi", default=300, help="Figure resolution in dpi.")
    parser.add_argument("--symmetric", default="auto", choices=["auto", "yes", "no"],
                        help="streamed .npy mode: skip the transpose detection (a full "
                             "extra read of a multi-GB artifact) when you already know.")
    args = _parse_args_or_exit(parser, argv)
    _device(args)

    from seekr_tpu_torch.viz import visualize_distro

    visualize_distro(args.adj, outputname=args.outputname, bins=int(args.bins),
                     pformat=args.pformat, pdpi=int(args.pdpi),
                     symmetric={"auto": None, "yes": True, "no": False}[args.symmetric])


# -- graph -------------------------------------------------------------------

def console_graph(argv=None):
    parser = _parser(GRAPH_DOC)
    parser.add_argument("adj", help="Adjacency matrix (.npy or labeled CSV), e.g. a "
                                    "pearson output.")
    parser.add_argument("-g", "--gml_path", default="graph.gml",
                        help="Path for the Group-annotated GML file.")
    parser.add_argument("-c", "--csv_path", default="graph.csv",
                        help="Path for the node-to-community CSV.")
    parser.add_argument("-t", "--threshold", default=0, type=float,
                        help="Zero adjacency entries below this value.")
    parser.add_argument("-m", "--gamma", default=1.0, type=float,
                        help="Resolution parameter of the partition.")
    parser.add_argument("-n", "--n_comms", default=5, type=int,
                        help="Cap on the number of distinct community ids.")
    parser.add_argument("-s", "--seed", default=None,
                        help="Partition RNG seed (default: unseeded).")
    args = _parse_args_or_exit(parser, argv)
    _device(args)

    from seekr_tpu_torch.graph.maker import Maker

    Maker(args.adj, gml_path=args.gml_path, csv_path=args.csv_path,
          threshold=float(args.threshold), gamma=float(args.gamma),
          n_comms=int(args.n_comms),
          seed=None if args.seed is None else int(args.seed)).make_gml_csv_files()


# -- doctor ------------------------------------------------------------------

def console_doctor(argv=None):
    parser = argparse.ArgumentParser(usage=DOCTOR_DOC,
                                     formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--device-timeout", default=90.0, type=float,
                        help="seconds before the card probe is declared hung.")
    parser.add_argument("--no-device", action="store_true",
                        help="skip the card, the CUDA build and the probe (host-only).")
    parser.add_argument("--device", default="cuda:0",
                        help="the CUDA card to probe, in a subprocess.")
    argv = sys.argv[1:] if argv is None else argv
    args = _parse_args_or_exit(parser, argv or ["--device", "cuda:0"])  # a bare doctor runs

    from seekr_tpu_torch.utils.doctor import run_doctor

    healthy = run_doctor(device_timeout=args.device_timeout, skip_device=args.no_device,
                         device=args.device)
    sys.exit(0 if healthy else 1)


# -- help ------------------------------------------------------------------

def console_seekr_help(argv=None):
    """The full manual: every command's harvested parser, in ``COMMANDS`` order.

    Each section is the command's own help (its doc and every positional and
    flag with its default), so the manual cannot drift from the real parsers.
    Building the parsers imports no plotting library.
    """
    from seekr_tpu_torch.__version__ import __version__

    parser = argparse.ArgumentParser()
    parser.add_argument("-v", "--version", action="store_true",
                        help="Print current version and exit.")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if args.version:
        print(__version__)
        return
    print(f"Welcome to seekr_tpu_torch! ({__version__})\n"
          "The PyTorch/CUDA port of seekr_tpu, with the seekr command set.\n"
          "Below is the full manual: every command with its complete argument and "
          "default table.\n")
    for cmd, fn in COMMANDS.items():
        if fn is console_seekr_help:
            continue
        try:
            parser = _collect_parser(fn)
        except Exception as err:  # one broken command must not take down the manual
            print(f"{'=' * 25}\n{cmd}\n{'=' * 25}\n"
                  f"  (flag table unavailable here: {type(err).__name__}: {err};\n"
                  f"   run `python -m seekr_tpu_torch.cli {cmd} --help` for details)\n")
            continue
        parser.prog = f"python -m seekr_tpu_torch.cli {cmd}"
        print(f"{'=' * 25}\n{cmd}\n{'=' * 25}\n{parser.format_help()}")
    print("Each section above is identical to running the command with no "
          "parameters (or --help).")


# -- module dispatcher (python -m seekr_tpu_torch.cli <command> ...) -----------

COMMANDS = {
    "download_gencode": console_download_gencode,
    "filter_gencode": console_filter_gencode,
    "kmer_counts": console_kmer_counts,
    "pearson": console_pearson,
    "norm_vectors": console_norm_vectors,
    "find_dist": console_find_dist,
    "find_pval": console_find_pval,
    "adj_pval": console_adj_pval,
    "kmer_heatmap": console_kmer_heatmap,
    "kmer_dendrogram": console_kmer_dendrogram,
    "kmer_leiden": console_kmer_leiden,
    "kmer_count_barplot": console_kmer_count_barplot,
    "kmer_msd_barplot": console_kmer_msd_barplot,
    "kmer_comp_textplot": console_kmer_comp_textplot,
    "kmer_indi_textplot": console_kmer_indi_textplot,
    "gen_rand_rnas": console_gen_rand_rnas,
    "pwms": console_pwms,
    "graph": console_graph,
    "domain_pearson": console_domain_pearson,
    "visualize_distro": console_visualize_distro,
    "canonical_gencode": console_canonical_gencode,
    "pipeline": console_pipeline,
    "serve": console_serve,
    "query": console_query,
    "doctor": console_doctor,
    "help": console_seekr_help,
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
