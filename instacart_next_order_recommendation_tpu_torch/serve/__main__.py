from instacart_next_order_recommendation_tpu_torch.serve.recommender import main

main()
