"""Primitive NN blocks of the port (port of decafnet_tpu.nn)."""

from .blocks import (FFN, AttNPool1D, Conv1d, ConvAttNLayer, ConvXAttNLayer,
                     LayerNorm, LayerScale, MaskedConv1D, MaskedMHA, Scale,
                     TorchLayerNorm, TransformerDecoder, TransformerEncoder,
                     reset_parameters)
