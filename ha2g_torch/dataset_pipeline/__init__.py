"""The offline dataset-construction pipeline (the port of
ha2g_tpu/dataset_pipeline/): external-tool runners with artifact-level
resume, main-speaker selection and the clip filter, assembly into clip
storage, and the headless QA report.  Host only."""

from ha2g_torch.dataset_pipeline.assemble import assemble_clips, split_clips
from ha2g_torch.dataset_pipeline.filtering import (ClipFilter,
                                                   select_main_speaker)
