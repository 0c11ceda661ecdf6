from ripor_tpu_torch.decode.beam import (
    BeamSearchOutput,
    beam_search,
    expand_groups_to_docids,
    make_beam_search_fn,
)

__all__ = ["BeamSearchOutput", "beam_search", "expand_groups_to_docids",
           "make_beam_search_fn"]
