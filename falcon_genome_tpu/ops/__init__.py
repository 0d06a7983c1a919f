"""DP inner loops — XLA wavefronts, CUDA kernels, golden reference models.

These are the in-repo replacements for the external accelerated engines the
reference forks (SURVEY.md §2.4 judge checklist): the PairHMM forward of
GATK HaplotypeCaller/Mutect2 (served by the Blaze NAM FPGA in the reference,
src/workers/BlazeWorker.cpp) and the banded Smith-Waterman seed extension of
bwa-flow (bwa.fpga.bit_path xclbin, src/workers/BWAWorker.cpp:161-166).

Every kernel has a NumPy float64 golden model (``*_ref.py``) that defines
numerical ground truth for tests.
"""
from .pairhmm import pairhmm_logp, PairHMMParams
from .pairhmm_ref import pairhmm_logp_ref

__all__ = ["pairhmm_logp", "PairHMMParams", "pairhmm_logp_ref"]
