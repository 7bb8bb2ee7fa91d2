"""Cohort metadata: modality order and clinical-score display names.

A copy of ``multivae_tpu/data/cohorts.py``. The short-name tables mirror
``experiments/multimodal_cohort/constants.py`` (they are cohort data, not
code); unknown cohorts fall back to identity naming so synthetic datasets
plot cleanly.
"""

indices = {"clinical": 0, "rois": 1}
modalities = ["clinical", "rois"]


def split_roi_metric(name):
    """Split a ROI feature name ``<base>_<metric>`` (e.g.
    ``G_precentral_lh_thickness`` → ``("G_precentral_lh", "thickness")``).
    The single convention shared by the DAA/plot/univariate workflows.
    A metric-less name (no separator) yields an empty metric instead of
    crashing the plotting workflows."""
    name = str(name)
    if "_" not in name:
        return name, ""
    base, metric = name.rsplit("_", 1)
    return base, metric

short_clinical_names = {
    "euaims": {
        "t1_rbs_total": "RBS",
        "t1_srs_rawscore": "SRS",
        "t1_adhd_hyperimpul_parent": "ADHD hi",
        "t1_adhd_inattentiv_parent": "ADHD inat",
        "t1_dawba_anx": "DAWBA anx",
        "t1_dawba_dep": "DAWBA dep",
        "t1_dawba_behavdis": "DAWBA bd",
    },
    "hbn": {
        "SCARED_P_Total": "SCARED",
        "SDQ_Hyperactivity": "SDQ ha",
        "SRS_Total": "SRS",
        "CBCL_WD": "CBCL wd",
        "CBCL_AB": "CBCL ab",
        "CBCL_AP": "CBCL ap",
        "ARI_P_Total_Score": "ARI",
    },
}


def get_short_clinical_names(dataset: str, clinical_names=None):
    """Short display names; identity mapping for unknown cohorts."""
    if dataset in short_clinical_names:
        return short_clinical_names[dataset]
    if clinical_names is not None:
        return {str(n): str(n) for n in clinical_names}
    return {}
