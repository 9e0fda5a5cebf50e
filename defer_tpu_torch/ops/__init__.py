from .quant import (BLOCK as QUANT_BLOCK, dequantize_int8_blocks,
                    quantize_int8_blocks, quantize_int8_blocks_plain,
                    quantized_ring_hop, ste_ring_hop)

__all__ = ["QUANT_BLOCK", "dequantize_int8_blocks", "quantize_int8_blocks",
           "quantize_int8_blocks_plain", "quantized_ring_hop",
           "ste_ring_hop"]
