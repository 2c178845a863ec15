"""krisp_tpu: an accelerator-native k-mer set-analysis engine for CRISPR/PCR
diagnostic assay design.

Re-implements the capabilities of grunwaldlab/krisp (kstream, krisp_fasta,
krisp_vcf) as a JAX/XLA pipeline: 2-bit/4-bit packed k-mer keys,
on-device sort, segment-reduction intersection, vectorized variant
classification, and a self-contained thermodynamic primer-design engine.
"""

__version__ = "0.2.0"
