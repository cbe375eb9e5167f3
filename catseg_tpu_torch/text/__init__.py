"""Class-name -> text-feature pipeline, with the port's own copies of the CLIP
BPE tokenizer, its merge table and the prompt templates."""
