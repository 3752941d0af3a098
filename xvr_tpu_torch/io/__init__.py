from .dicom import Dataset, dcmread, dcmwrite, pixel_array
from .nifti import load_nifti, save_nifti, to_canonical
from .volumes import parse_labels, read
from .xray import dicom_group_key, parse_dicom_pose, read_xray

__all__ = [
    "Dataset",
    "dcmread",
    "dcmwrite",
    "dicom_group_key",
    "load_nifti",
    "parse_dicom_pose",
    "parse_labels",
    "pixel_array",
    "read",
    "read_xray",
    "save_nifti",
    "to_canonical",
]
