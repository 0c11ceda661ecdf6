from ripor_tpu_torch.decode.beam import (
    BeamSearchOutput,
    beam_search,
    expand_groups_to_docids,
    make_beam_search_fn,
    make_sharded_beam_search_fn,
    make_tp_beam_search_fn,
    pad_batch_to_data_axis,
)

__all__ = ["BeamSearchOutput", "beam_search", "expand_groups_to_docids",
           "make_beam_search_fn", "make_sharded_beam_search_fn",
           "make_tp_beam_search_fn", "pad_batch_to_data_axis"]
