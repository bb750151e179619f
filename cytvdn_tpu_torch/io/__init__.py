from cytvdn_tpu_torch.io.emd import read_emd, write_emd, write_emd_regions
from cytvdn_tpu_torch.io.loaders import open_input, load_input

__all__ = [
    "read_emd",
    "write_emd",
    "write_emd_regions",
    "open_input",
    "load_input",
]
