from repro_torch.data.synthetic import (ShapesDatasetConfig,
                                        TokenDatasetConfig, host_shard_slice,
                                        shapes_batch_iterator,
                                        token_batch_iterator)
