"""Loading catseg_tpu parameters into the port."""
