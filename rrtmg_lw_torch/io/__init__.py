"""Column-mode input and output (numpy only): the counterpart of
``rrtmg_lw_tpu.io``."""

from .column_input import (CloudInput, ColumnCase, read_in_aer_rrtm,
                           read_in_cld_rrtm, read_input_rrtm)
from .column_output import format_flux_table, write_output_rrtm

__all__ = [
    "ColumnCase", "CloudInput", "read_input_rrtm", "read_in_cld_rrtm",
    "read_in_aer_rrtm", "format_flux_table", "write_output_rrtm",
]
