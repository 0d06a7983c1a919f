"""Variant-calling model families.

The reference drives these as external GATK walkers (SURVEY.md §2.2):
HaplotypeCaller (germline, row 13), Mutect2 (somatic T/N, row 15),
UnifiedGenotyper (legacy pileup caller, row 23), joint genotyping
(rows 17-18).  Here each is an in-repo model whose hot loop (PairHMM read
likelihoods) runs on the device kernel, with host-side assembly/genotyping
around it.
"""
from .haplotypecaller import HaplotypeCaller, HTCParams

__all__ = ["HaplotypeCaller", "HTCParams"]
