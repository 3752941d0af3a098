"""``dcm2nii INPATH OUTPATH``: bake a DICOM series into one NIfTI volume.

Counterpart of ``xvr_tpu.cli.commands.dcm2nii`` on ``argparse``; the
converter is :func:`xvr_tpu_torch.io.dcm2nii.dicom_series_to_nifti`.
"""

from __future__ import annotations

import argparse

from .register import existing_path


def dcm2nii(kw):
    """Convert a DICOMDIR to a NIfTI file."""
    from ...io.dcm2nii import dicom_series_to_nifti

    print(f"Converting {kw['inpath']} to {kw['outpath']}", flush=True)
    return dicom_series_to_nifti(kw["inpath"], kw["outpath"])


def add_dcm2nii_parser(subparsers) -> argparse.ArgumentParser:
    p = subparsers.add_parser("dcm2nii", help=dcm2nii.__doc__, description=dcm2nii.__doc__)
    p.add_argument("inpath", type=existing_path, help="DICOM series: a directory or one file")
    p.add_argument("outpath", type=str, help="NIfTI file to write")
    p.set_defaults(func=dcm2nii)
    return p
