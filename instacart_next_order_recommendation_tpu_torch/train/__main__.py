from instacart_next_order_recommendation_tpu_torch.train.trainer import main

main()
