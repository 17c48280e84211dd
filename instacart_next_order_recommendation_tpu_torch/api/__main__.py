from instacart_next_order_recommendation_tpu_torch.api.app import main

main()
