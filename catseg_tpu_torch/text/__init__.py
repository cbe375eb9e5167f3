"""Class-name -> text-feature pipeline (tokenizer and templates come from catseg_tpu.text)."""
