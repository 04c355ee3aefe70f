"""Training: AdamW and its factored form (``optimizer``), the train step with
microbatch accumulation and int8 gradient compression (``train_step``)."""
