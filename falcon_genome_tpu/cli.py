"""CLI: ``falcon-genome-tpu <subcommand>`` dispatch.

Mirrors the reference's command surface and exit-code policy
(src/main.cpp:17-41 help table, :56-74 entry points, :176-238 exception →
exit-code mapping) over the in-repo stages.
"""
from __future__ import annotations

import argparse
import logging
import sys

from . import __version__, config as config_mod
from .utils.errors import (
    FGError, HelpRequest, InvalidParam, SilentExit, exit_code_for)

log = logging.getLogger("falcon_genome_tpu")

COMMANDS = {
    "align": "align pair-end FASTQ files into a sorted BAM file",
    "markdup": "mark duplicates in a BAM file or bucket folder",
    "baserecal": "build the base-quality recalibration table",
    "printreads": "apply recalibration, emit sharded BAM",
    "bqsr": "base recalibration + print reads (chained)",
    "htc": "call germline variants with the HaplotypeCaller model",
    "mutect2": "call somatic variants on a tumor/normal pair",
    "indel": "indel realignment (legacy)",
    "joint": "joint genotyping across per-sample gVCFs",
    "ug": "call variants with the legacy pileup genotyper",
    "gatk": "dispatch a GATK-style walker invocation to in-repo stages",
    "depth": "depth of coverage analysis",
    "vcf_filter": "filter variants by expression",
    "germline": "one-command germline pipeline (align → markdup → bqsr → htc)",
    "concat": "concatenate per-shard VCFs",
    "conf": "print all configuration options",
}


def print_help() -> None:
    print("Falcon Genome Analysis Kit "
          f"(falcon-genome-tpu) v{__version__}")
    print("Usage: falcon-genome-tpu [command] <options>\n")
    print("Commands:")
    for name, desc in COMMANDS.items():
        print(f"  {name:12s} {desc}")


def _base(p: argparse.ArgumentParser, ref=True, output=True):
    if ref:
        p.add_argument("-r", "--ref", required=True, help="reference FASTA")
    if output:
        p.add_argument("-o", "--output", required=True)
    p.add_argument("-f", "--force", action="store_true",
                   help="overwrite outputs")
    p.add_argument("-O", "--option", action="append", default=[],
                   metavar="KEY=VALUE", help="config override")
    p.add_argument("--extra-options", action="append", default=[],
                   help="per-tool flag overrides, GATK-style "
                   "(e.g. \"-ERC NONE -stand_call_conf 30\"); "
                   "override-wins vs stage defaults")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="falcon-genome-tpu", add_help=False)
    sub = ap.add_subparsers(dest="command")

    p = sub.add_parser("align")
    _base(p)
    p.add_argument("-1", "--fastq1")
    p.add_argument("-2", "--fastq2")
    p.add_argument("-F", "--sample-sheet")
    p.add_argument("-S", "--sample-id", default="sample")
    p.add_argument("-R", "--rg", default="rg0", help="read group id")
    p.add_argument("-L", "--library", default="lib0")
    p.add_argument("-P", "--platform", default="illumina")
    p.add_argument("--disable-merge", action="store_true")
    p.add_argument("--num-buckets", type=int, default=0)
    p.add_argument("--long-reads", action="store_true",
                   help="minimap-class long-read alignment "
                        "(gap-cost chaining, single-end records)")

    p = sub.add_parser("markdup")
    _base(p, ref=False)
    p.add_argument("-i", "--input", required=True)

    for name in ("baserecal", "printreads", "bqsr"):
        p = sub.add_parser(name)
        _base(p)
        p.add_argument("-i", "--input", required=True)
        p.add_argument("-K", "--knownSites", action="append", default=[])
        if name == "printreads":
            p.add_argument("-b", "--bqsr", required=True,
                           help="recalibration table path")

    p = sub.add_parser("htc")
    _base(p)
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-v", "--produce-vcf", action="store_true")
    p.add_argument("-L", "--intervals")
    p.add_argument("-S", "--sample-id", default="SAMPLE")

    p = sub.add_parser("mutect2")
    _base(p)
    p.add_argument("-t", "--tumor", required=True)
    p.add_argument("-n", "--normal")
    p.add_argument("-L", "--intervals")
    p.add_argument("--skip-filter", action="store_true")
    # resource surface (ref worker-mutect2.cpp:64-72)
    p.add_argument("-d", "--dbsnp", action="append", default=[])
    p.add_argument("-c", "--cosmic", action="append", default=[])
    p.add_argument("-m", "--germline")
    p.add_argument("-p", "--panels_of_normals", "--panel-of-normals",
                   dest="panels_of_normals")
    p.add_argument("--contamination_table", "--contamination-table",
                   dest="contamination_table")
    p.add_argument("-a", "--normal_name", default="NORMAL")
    p.add_argument("-b", "--tumor_name", default="TUMOR")

    p = sub.add_parser("indel")
    _base(p)
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-K", "--knownSites", action="append", default=[])

    p = sub.add_parser("joint")
    _base(p)
    p.add_argument("-i", "--input-dir", required=True)

    p = sub.add_parser("ug")
    _base(p)
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-L", "--intervals")
    p.add_argument("-S", "--sample-id", default="SAMPLE")

    p = sub.add_parser("gatk")
    p.add_argument("gatk_args", nargs=argparse.REMAINDER)

    p = sub.add_parser("depth")
    _base(p)
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-L", "--intervals")
    p.add_argument("-S", "--sample-id", default="SAMPLE")
    # ref worker-depth.cpp:29-35
    p.add_argument("-g", "--geneList", dest="gene_list")
    p.add_argument("-b", "--omitBaseOutput", dest="omit_base",
                   action="store_true", default=None,
                   help="omit per-base coverage output")
    p.add_argument("--emitBaseOutput", dest="omit_base",
                   action="store_false",
                   help="write per-base coverage (large)")
    p.add_argument("-v", "--omitIntervals", dest="omit_intervals",
                   action="store_true")
    p.add_argument("-s", "--omitSampleSummary", dest="omit_summary",
                   action="store_true")

    p = sub.add_parser("vcf_filter")
    _base(p)
    p.add_argument("-i", "--input", required=True)
    p.add_argument("--filter-expression", required=True)
    p.add_argument("--filter-name", default="FILTERED")

    p = sub.add_parser("germline")
    _base(p)
    p.add_argument("-1", "--fastq1")
    p.add_argument("-2", "--fastq2")
    p.add_argument("-F", "--sample-sheet")
    p.add_argument("-S", "--sample-id", default="sample")
    p.add_argument("-R", "--rg", default="rg0")
    p.add_argument("-v", "--produce-vcf", action="store_true")
    p.add_argument("--long-reads", action="store_true",
                   help="minimap-class long-read alignment (the fast-"
                        "germline driver's Minimap2Worker path)")

    p = sub.add_parser("concat")
    _base(p, ref=False)
    p.add_argument("-i", "--input-dir", required=True)

    sub.add_parser("conf")
    return ap


# commands whose hot path dispatches device kernels: these bring up the
# (possibly multi-process) device mesh before running (the reference's
# scale-out bring-up — mpirun/ssh wrapping in Executor/BWAWorker — happens
# per-command too)
DEVICE_COMMANDS = {"align", "baserecal", "printreads", "bqsr", "htc",
                   "mutect2", "indel", "ug", "germline", "gatk"}


def dispatch(args: argparse.Namespace, conf) -> None:
    from . import stages

    for kv in getattr(args, "option", []) or []:
        if "=" not in kv:
            raise InvalidParam(f"-O expects KEY=VALUE, got {kv!r}")
        k, v = kv.split("=", 1)
        conf.set(k, v)

    cmd = args.command
    if cmd in DEVICE_COMMANDS:
        from .parallel.mesh import initialize_from_conf
        initialize_from_conf(conf)
    if cmd == "align":
        stages.run_align(conf, args.ref, args.output,
                         fastq1=args.fastq1, fastq2=args.fastq2,
                         sample_sheet=args.sample_sheet,
                         sample_id=args.sample_id, read_group=args.rg,
                         platform=args.platform, library=args.library,
                         num_buckets=args.num_buckets,
                         merge=not args.disable_merge,
                         long_reads=args.long_reads, force=args.force,
                         extra_opts=args.extra_options)
    elif cmd == "markdup":
        stages.run_markdup(conf, args.input, args.output, force=args.force,
                           extra_opts=args.extra_options)
    elif cmd == "baserecal":
        stages.run_baserecal(conf, args.ref, args.input, args.output,
                             known_sites=args.knownSites, force=args.force,
                             extra_opts=args.extra_options)
    elif cmd == "printreads":
        stages.run_printreads(conf, args.ref, args.input, args.bqsr,
                              args.output, force=args.force,
                              extra_opts=args.extra_options)
    elif cmd == "bqsr":
        stages.run_bqsr(conf, args.ref, args.input, args.output,
                        known_sites=args.knownSites, force=args.force,
                        extra_opts=args.extra_options)
    elif cmd == "htc":
        stages.run_htc(conf, args.ref, args.input, args.output,
                       produce_vcf=args.produce_vcf,
                       intervals=args.intervals, sample=args.sample_id,
                       force=args.force, extra_opts=args.extra_options)
    elif cmd == "mutect2":
        stages.run_mutect2(conf, args.ref, args.tumor, args.output,
                           normal_path=args.normal,
                           intervals=args.intervals,
                           run_filter=not args.skip_filter,
                           force=args.force,
                           tumor_name=args.tumor_name,
                           normal_name=args.normal_name,
                           dbsnp=args.dbsnp, cosmic=args.cosmic,
                           germline=args.germline,
                           panels_of_normals=args.panels_of_normals,
                           contamination_table=args.contamination_table,
                           extra_opts=args.extra_options)
    elif cmd == "indel":
        from .stages.indel import run_indel
        run_indel(conf, args.ref, args.input, args.output,
                  force=args.force, extra_opts=args.extra_options)
    elif cmd == "joint":
        stages.run_joint(conf, args.ref, args.input_dir, args.output,
                         force=args.force, extra_opts=args.extra_options)
    elif cmd == "ug":
        stages.run_ug(conf, args.ref, args.input, args.output,
                      intervals=args.intervals, sample=args.sample_id,
                      force=args.force, extra_opts=args.extra_options)
    elif cmd == "gatk":
        _dispatch_gatk(conf, args.gatk_args)
    elif cmd == "depth":
        # per-base output is on by default as in the reference (GATK
        # DepthOfCoverage); -b/--omitBaseOutput turns it off
        omit_base = args.omit_base if args.omit_base is not None else False
        stages.run_depth(conf, args.ref, args.input, args.output,
                         intervals=args.intervals, sample=args.sample_id,
                         gene_list=args.gene_list,
                         omit_base_output=omit_base,
                         omit_intervals=args.omit_intervals,
                         omit_sample_summary=args.omit_summary,
                         force=args.force, extra_opts=args.extra_options)
    elif cmd == "vcf_filter":
        stages.run_vcf_filter(conf, args.ref, args.input, args.output,
                              filter_expr=args.filter_expression,
                              filter_name=args.filter_name,
                              force=args.force,
                              extra_opts=args.extra_options)
    elif cmd == "germline":
        stages.run_germline(conf, args.ref, args.output,
                            fastq1=args.fastq1, fastq2=args.fastq2,
                            sample_sheet=args.sample_sheet,
                            sample_id=args.sample_id, read_group=args.rg,
                            produce_vcf=args.produce_vcf,
                            long_reads=args.long_reads, force=args.force,
                            extra_opts=args.extra_options)
    elif cmd == "concat":
        stages.run_concat(conf, args.input_dir, args.output,
                          force=args.force)
    else:
        raise InvalidParam(f"unknown command {cmd!r}")


_GATK_TOOL_MAP = {
    "HaplotypeCaller": "htc",
    "BaseRecalibrator": "baserecal",
    "PrintReads": "printreads",
    "ApplyBQSR": "printreads",
    "Mutect2": "mutect2",
    "UnifiedGenotyper": "ug",
    "DepthOfCoverage": "depth",
    "VariantFiltration": "vcf_filter",
    "GenotypeGVCFs": "joint",
}


def _dispatch_gatk(conf, gatk_args: list[str]) -> None:
    """``gatk`` passthrough (ref worker-gatk.cpp): the reference escapes
    args into a stock GATK jar; there is no external GATK here, so
    recognizable walker invocations (GATK3 ``-T Tool`` or GATK4
    ``Tool ...``) are translated onto the equivalent in-repo subcommand
    and dispatched."""
    tool = None
    args = list(gatk_args)
    for i, a in enumerate(args):
        if a in ("-T", "--analysis_type") and i + 1 < len(args):
            tool = args[i + 1]
            del args[i:i + 2]
            break
        if a in _GATK_TOOL_MAP:
            tool = a
            del args[i]
            break
    if tool is None or tool not in _GATK_TOOL_MAP:
        raise InvalidParam(
            "gatk passthrough: unrecognized walker; supported: "
            + ", ".join(sorted(_GATK_TOOL_MAP)))
    sub = _GATK_TOOL_MAP[tool]

    flag_map = {
        "-R": "-r", "--reference": "-r", "--reference_sequence": "-r",
        "-I": "-i", "--input": "-i", "--input_file": "-i",
        "-O": "-o", "--output": "-o",
        "-L": "-L", "--intervals": "-L",
        "-bqsr": "-b", "--bqsr-recal-file": "-b", "-BQSR": "-b",
        "-f": "-f", "--force": "-f",
    }
    translated: list[str] = [sub]
    produce_vcf = True
    i = 0
    while i < len(args):
        a = args[i]
        if a in ("-o",):                    # GATK3 lowercase output
            translated += ["-o", args[i + 1]]
            i += 2
        elif a in ("-ERC", "--emit-ref-confidence", "--emitRefConfidence"):
            if i + 1 < len(args) and args[i + 1].upper() == "GVCF":
                produce_vcf = False
            i += 2
        elif a in ("-tumor", "--tumor-sample"):
            i += 2                           # sample naming is implicit
        elif a in ("-normal", "--normal-sample"):
            i += 2
        elif a in flag_map:
            tgt = flag_map[a]
            if tgt == "-f":
                translated.append("-f")
                i += 1
            else:
                translated += [tgt, args[i + 1]]
                i += 2
        else:
            log.warning("gatk passthrough: ignoring argument %r", a)
            i += 1
    if sub == "htc" and produce_vcf:
        translated.append("--produce-vcf")
    log.info("gatk passthrough: %s %s → falcon-genome-tpu %s",
             tool, " ".join(gatk_args), " ".join(translated))
    ap = build_parser()
    dispatch(ap.parse_args(translated), conf)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s] %(message)s")
    try:
        if not argv or argv[0] in ("-h", "--help", "help"):
            print_help()
            return 0
        conf = config_mod.init()
        if argv[0] == "conf":
            print(conf.dump())
            return 0
        if argv[0] not in COMMANDS:
            print_help()
            raise InvalidParam(f"unknown command {argv[0]!r}")
        if argv[0] == "gatk":
            # verbatim passthrough (argparse REMAINDER chokes on leading
            # GATK3 '-T'; the reference escapes args untouched too)
            _dispatch_gatk(conf, argv[1:])
            return 0
        ap = build_parser()
        args = ap.parse_args(argv)
        dispatch(args, conf)
        return 0
    except (HelpRequest, SilentExit) as e:
        msg = str(e)
        if msg:
            print(msg, file=sys.stderr)
        return exit_code_for(e)
    except FGError as e:
        log.error("%s", e)
        return exit_code_for(e)
    except Exception as e:  # runtime_error → 255 (ref main.cpp:231-238)
        log.error("internal error: %s", e, exc_info=True)
        return 255


if __name__ == "__main__":
    sys.exit(main())
