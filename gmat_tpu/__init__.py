"""gmat-tpu: genomic multivariate analysis (REMMAX) on JAX accelerators.

A ground-up JAX/XLA re-design with the capabilities of the reference GMAT
package (see SURVEY.md): PLINK IO, genomic relationship matrices,
multi-GRM weighted EM+AI REML, single-SNP and exhaustive/approximate
epistasis score tests, and longitudinal (random-regression) GWAS — sharded
over device meshes.

The public API mirrors the reference's entry points (reference module in
parentheses):

- `agmat`, `dgmat_as`, `ginbreedcoef`              (gmat.gmatrix)
- `read_plink`, `impute_geno`, `shuffle_bed`, `Bed` (gmat.process_plink)
- `wemai_multi_gmat`, `wemai_multi_gmat_pred`      (gmat.uvlmm)
- `remma_add`, `remma_dom`, epiAA/AD/DD families    (gmat.remma)
- `annotation_snp_pos`, `random_pair[AD]`          (gmat.remma)
- `balance_*`, `unbalance_*` longwas pipelines     (gmat.longwas)
- `ped_*` pedigree tools                           (gmat.pedigree)
- `simu_epistasis[_freq]`                          (gmat.remma.simu)
"""
from gmat_tpu import config  # noqa: F401  -- sets the x64 policy first
from gmat_tpu.grm.grm import agmat, dgmat_as, ginbreedcoef  # noqa: F401
from gmat_tpu.io.bed import (  # noqa: F401
    Bed,
    impute_geno,
    read_plink,
    shuffle_bed,
    write_bed,
)
from gmat_tpu.reml.wemai import (  # noqa: F401
    wemai_multi_gmat,
    wemai_multi_gmat_pred,
)
from gmat_tpu.reml.eigen import uvlmm_varcom_eigen  # noqa: F401
from gmat_tpu.reml.mme import (  # noqa: F401
    ai_mme,
    em_mme,
    emai_mme,
    pxem_mme,
    pxemai_mme,
)
from gmat_tpu.scan.fixed_gwas import (  # noqa: F401
    lm_pred,
    lm_snp_eff,
    uvlmm_gwas_add,
    uvlmm_gwas_add_eigen,
    uvlmm_gwas_dom,
    uvlmm_gwas_dom_eigen,
    uvlmm_gwas_epiAA,
)
from gmat_tpu.scan.annotation import (  # noqa: F401
    annotation_snp_nearest_gene,
    annotation_snp_pos,
    gtf_to_gene_info,
)
from gmat_tpu.scan.pairs import (  # noqa: F401
    remma_epiAA,
    remma_epiAA_pair,
    remma_epiAA_parallel,
    remma_epiAD,
    remma_epiAD_pair,
    remma_epiAD_parallel,
    remma_epiDD,
    remma_epiDD_pair,
    remma_epiDD_parallel,
)
from gmat_tpu.scan.random_pair import random_pair, random_pairAD  # noqa: F401
from gmat_tpu.scan.screen import (  # noqa: F401
    remma_epiAA_approx,
    remma_epiAA_approx_parallel,
    remma_epiAA_eff,
    remma_epiAA_eff_parallel,
    remma_epiAA_maf_approx,
    remma_epiAA_maf_approx_parallel,
    remma_epiAA_maf_eff,
    remma_epiAA_maf_eff_parallel,
    remma_epiAD_approx,
    remma_epiAD_approx_parallel,
    remma_epiAD_eff,
    remma_epiAD_eff_parallel,
    remma_epiAD_maf_approx,
    remma_epiAD_maf_approx_parallel,
    remma_epiAD_maf_eff,
    remma_epiAD_maf_eff_parallel,
    remma_epiDD_approx,
    remma_epiDD_approx_parallel,
    remma_epiDD_eff,
    remma_epiDD_eff_parallel,
    remma_epiDD_maf_approx,
    remma_epiDD_maf_approx_parallel,
    remma_epiDD_maf_eff,
    remma_epiDD_maf_eff_parallel,
)
from gmat_tpu.scan.accel import remma_epiAA_eff_gpu  # noqa: F401
from gmat_tpu.scan.array_api import (  # noqa: F401
    _remma_add,
    _remma_dom,
    _remma_epiAA,
    _remma_epiAA_eff,
    _remma_epiAA_eff_parallel,
    _remma_epiAA_maf_eff,
    _remma_epiAA_pair,
    _remma_epiAA_parallel,
    _remma_epiAD,
    _remma_epiAD_eff,
    _remma_epiAD_eff_parallel,
    _remma_epiAD_maf_eff,
    _remma_epiAD_pair,
    _remma_epiAD_parallel,
    _remma_epiDD,
    _remma_epiDD_eff,
    _remma_epiDD_eff_parallel,
    _remma_epiDD_maf_eff,
    _remma_epiDD_pair,
    _remma_epiDD_parallel,
    _wemai_multi_gmat,
)
from gmat_tpu.io.pheno import (  # noqa: F401
    design_matrix_wemai_multi_gmat,
    design_matrix_wemai_multi_gmat_pred,
)
from gmat_tpu.scan.single import remma_add, remma_dom  # noqa: F401
from gmat_tpu.pipeline.simulate import (  # noqa: F401
    simu_epistasis,
    simu_epistasis_freq,
)
from gmat_tpu.pedigree.pedigree import (  # noqa: F401
    ped_completeness,
    ped_correct,
    ped_recode,
    ped_sort,
    ped_trace,
)

__version__ = "0.1.0"
