"""Entropy tier: destuffing, table packing, K1 Huffman decode, K4 entropy
encode and wire assembly."""
