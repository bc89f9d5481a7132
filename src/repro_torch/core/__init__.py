"""Core sketching library: CS / TS / HCS / FCS (the paper's contribution),
the port of ``repro/core``.

Public API:
  hashes       : make_mode_hash / make_tensor_hashes / fcs_sketch_len
  count_sketch : cs_apply / cs_apply_cols / cs_unsketch
  sketches     : {ts,fcs,hcs}_general, {ts,fcs,hcs}_cp, fcs_decompress_entry
  contraction  : fcs_tuuu / fcs_tiuu (+ts_*), kron + mode-contraction codecs
  estimators   : median_combine
"""
from repro_torch.core.hashes import (  # noqa: F401
    ModeHash, fcs_sketch_len, make_mode_hash, make_tensor_hashes,
    mode_hash_from_coeffs, storage_bytes_cs_long, storage_bytes_tabulated,
)
from repro_torch.core.count_sketch import (  # noqa: F401
    cs_apply, cs_apply_batch, cs_apply_cols, cs_unsketch, cs_unsketch_at,
)
from repro_torch.core.sketches import (  # noqa: F401
    fcs_cp, fcs_decompress_entry, fcs_general, hcs_cp, hcs_decompress_entry,
    hcs_general, ts_cp, ts_general,
)
from repro_torch.core.contraction import (  # noqa: F401
    fcs_contraction_compress, fcs_contraction_decompress, fcs_kron_compress,
    fcs_kron_decompress, fcs_tiuu, fcs_tuuu, ts_tiuu, ts_tuuu,
)
from repro_torch.core.estimators import median_combine, mean_combine  # noqa: F401
